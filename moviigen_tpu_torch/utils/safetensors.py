"""A small reader and writer of the safetensors format, with no dependency
beyond torch.

The format (public, https://github.com/huggingface/safetensors): an
8-byte little-endian header length n, n bytes of JSON mapping each tensor
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets
into the data that follows the header) plus an optional
``"__metadata__"`` dict of strings (``read_metadata``; the writer takes
one), then the raw little-endian tensor bytes. The writer pads
the header with spaces to a multiple of 8 bytes, as the reference writer
does, and lays the tensors out in name order.

The port keeps its own copy because the card's machine has no
``safetensors`` package; the tests hold it against that package both ways.
"""

from __future__ import annotations

import fnmatch
import json
import os
import struct
import sys
from typing import Dict, Optional

import torch

DTYPES = {
    "F32": torch.float32,
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "I32": torch.int32,
    "I64": torch.int64,
    "I8": torch.int8,
    "U8": torch.uint8,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}

if sys.byteorder != "little":  # the format and the raw views are little-endian
    raise ImportError("moviigen_tpu_torch.utils.safetensors needs a "
                      "little-endian host")


def _read_header(f) -> tuple:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError("safetensors: file shorter than its 8-byte header "
                         "length")
    (n,) = struct.unpack("<Q", raw)
    header = json.loads(f.read(n).decode("utf-8"))
    return header, 8 + n


def read_metadata(path: str) -> Dict[str, str]:
    """The header's ``__metadata__`` strings (empty if the file has none)."""
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return dict(header.get("__metadata__") or {})


def load_file(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Every tensor of a file, by name, on ``device`` (default CPU)."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        header, start = _read_header(f)
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in DTYPES:
                raise ValueError(f"safetensors: {path}: tensor {name!r} has "
                                 f"dtype {info['dtype']}, not one of "
                                 f"{sorted(DTYPES)}")
            dtype = DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape = list(info["shape"])
            count = 1
            for s in shape:
                count *= s
            if end - begin != count * dtype.itemsize:
                raise ValueError(f"safetensors: {path}: tensor {name!r} "
                                 f"spans {end - begin} bytes, its shape "
                                 f"{shape} needs {count * dtype.itemsize}")
            f.seek(start + begin)
            buf = bytearray(f.read(end - begin))
            if count == 0:
                t = torch.empty(shape, dtype=dtype)
            else:
                t = torch.frombuffer(buf, dtype=dtype).reshape(shape)
            out[name] = t if device is None else t.to(device)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; dtypes as ``DTYPES``) to ``path``,
    with ``metadata`` (str → str) in the header."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"safetensors: tensor {name!r} has dtype "
                             f"{t.dtype}, not one of {sorted(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().tobytes())
    os.replace(tmp, path)


def load_sharded(directory: str, pattern: str,
                 device=None) -> Dict[str, torch.Tensor]:
    """Every tensor of every file of ``directory`` matching ``pattern``
    (a sharded checkpoint); a name found in two shards raises."""
    files = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if fnmatch.fnmatch(f, pattern))
    if not files:
        raise FileNotFoundError(f"no {pattern} in {directory}")
    out: Dict[str, torch.Tensor] = {}
    for path in files:
        for name, t in load_file(path, device).items():
            if name in out:
                raise ValueError(f"safetensors: {name!r} is in more than "
                                 f"one shard of {directory}")
            out[name] = t
    return out
