"""Checkpoint save/restore, the reference-layout export and the LoRA
adapters' peft-layout export.

Counterpart of ``moviigen_tpu/training/checkpoint.py``: the layout
``<output_dir>/checkpoint-step_N/`` that the validation watcher scans
(ref ``valid_training.py:302-313``), with

- ``params.safetensors``: the trained tensors under the port's names
  (``utils/safetensors.py``): the model's parameters, or for a LoRA run
  the adapters alone (``lora.lora_state_dict``);
- ``opt_state.safetensors``: the optimizer state, the moments and the
  accumulated gradient under ``m/``, ``v/`` and ``acc/`` + the
  parameter's name, the counters in the header's metadata, and there
  too, when given, the state of the trainer's generator (the noise and
  timestep draws), so that a resumed run draws what the run that was
  stopped would have drawn next;
- ``meta.json``: ``{"step": N}`` plus the caller's keys (the CLI adds
  ``final``, ``lora`` and ``quant``, and for LoRA ``lora_rank``,
  ``lora_alpha`` and ``lora_dtype``, as the JAX CLI does);
- with ``export_safetensors``, ``diffusion_pytorch_model.safetensors``
  in the reference's diffusers key names (fp32), which both packages'
  ``load_wan_checkpoint`` read; for a LoRA run
  ``lora_adapter.safetensors`` and ``adapter_config.json`` instead
  (``export_lora_safetensors``).

Both ways stream one tensor at a time. Under a mesh (``comm=``) every
rank calls them, and the files are the same: each shard is gathered over
the shard axes just before rank 0 writes it (no rank holds more than its
shards plus one gathered tensor), and a restore reads each tensor alone
and keeps the rank's slice of each shard it holds. So a checkpoint
written by a mesh resumes in one process, in the validation watcher and
in the export, and one written by one process resumes on a mesh. Both
ways are bit-exact.
"""

from __future__ import annotations

import collections
import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..models.wan_convert import (EXPORT_NAME, export_wan_safetensors,
                                  wan_params_to_state_dict)
from ..utils.safetensors import (load_tensor, read_metadata,
                                 save_file, save_stream)

CKPT_RE = re.compile(r"checkpoint-step_(\d+)$")
PARAMS_FILE = "params.safetensors"
OPT_FILE = "opt_state.safetensors"
_MOMENTS = ("m", "v", "acc")

__all__ = ["CKPT_RE", "checkpoint_dir", "latest_checkpoint",
           "save_checkpoint", "restore_checkpoint", "read_meta",
           "export_wan_mesh_safetensors",
           "wan_params_to_state_dict", "export_wan_safetensors",
           "lora_to_peft_state_dict", "lora_from_peft_state_dict",
           "export_lora_safetensors"]


def checkpoint_dir(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, f"checkpoint-step_{step}")


def latest_checkpoint(output_dir: str) -> Optional[Tuple[str, int]]:
    """Newest checkpoint-step_N under output_dir (ref
    valid_training.py:301-313)."""
    best = None
    if not os.path.isdir(output_dir):
        return None
    for name in os.listdir(output_dir):
        m = CKPT_RE.match(name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(output_dir, name), step)
    return best


Tensors = Mapping[str, torch.Tensor]


def _named(params: Union[nn.Module, Tensors]) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _mesh_layout(params, comm):
    """(named tensors, {name: dim} of the shards among them, the shard
    axis, the comm: a mesh of one where ``comm`` is None); named tensors
    that are not a model are replicated."""
    from ..parallel.comm import Comm
    from ..parallel.sharding import shard_axis, sharded_tensors

    comm = Comm(1, 1, 1, 0) if comm is None else comm
    named = _named(params)
    sharded = sharded_tensors(params) if isinstance(params, nn.Module) \
        else {}
    return named, {n: d for n, d in sharded.items() if n in named}, \
        shard_axis(comm), comm


def _opt_index(named, optimizer) -> Dict[str, int]:
    """Each named tensor's place in the optimizer's parameter list."""
    place = {id(p): i for i, p in enumerate(optimizer.params)}
    missing = [n for n, t in named.items() if id(t) not in place]
    if missing or len(place) != len(named):
        raise ValueError("the optimizer's parameters are not the "
                         f"checkpoint's tensors (e.g. {missing[:4]})")
    return {n: place[id(t)] for n, t in named.items()}


@torch.no_grad()
def save_checkpoint(output_dir: str, step: int,
                    params: Union[nn.Module, Tensors], optimizer=None,
                    extra_meta: Optional[Dict[str, Any]] = None,
                    export_safetensors: bool = False, comm=None,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write ``checkpoint-step_{step}``: ``params`` (a model, whose
    parameters are saved, or named tensors such as the adapters'
    ``lora_state_dict``), the optimizer state (with ``generator``'s state
    beside it) and ``meta.json``; with
    ``export_safetensors`` also the model in the reference layout (a
    model only). With ``comm`` it is a collective call of every rank of a
    mesh: ``params`` is this rank's model (its shards found by
    ``sharding.sharded_tensors``) or named tensors, replicated (the LoRA
    adapters), and rank 0 writes. Returns the directory."""
    if export_safetensors and not isinstance(params, nn.Module):
        raise TypeError("export_safetensors writes a model; adapters go "
                        "through export_lora_safetensors")
    named, sharded, axis, comm = _mesh_layout(params, comm)
    path = checkpoint_dir(output_dir, step)
    writer = comm.rank == 0
    if writer:
        os.makedirs(path, exist_ok=True)
    _stream_gathered(os.path.join(path, PARAMS_FILE), comm, axis, sharded,
                     [(name, name, t) for name, t in named.items()])
    if optimizer is not None:
        index = _opt_index(named, optimizer)
        state = optimizer.state_dict()
        items = [(f"{k}/{name}", name, state[k][index[name]])
                 for k in _MOMENTS if state[k] is not None
                 for name in named]
        counters = {"count": state["count"],
                    "mini_step": state["mini_step"],
                    "acc": state["acc"] is not None}
        if generator is not None:
            counters["generator"] = bytes(
                generator.get_state().tolist()).hex()
        _stream_gathered(os.path.join(path, OPT_FILE), comm, axis,
                         sharded, items, counters)
    if writer:
        meta = {"step": step}
        if extra_meta:
            meta.update(extra_meta)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    if export_safetensors:
        export_wan_mesh_safetensors(os.path.join(path, EXPORT_NAME), params,
                                    comm)
    return path


def read_meta(path: str) -> Dict[str, Any]:
    """A checkpoint dir's ``meta.json`` (empty if it has none)."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _stream_gathered(file, comm, axis, sharded, items, metadata=None,
                     dtype=None, shapes=None) -> None:
    """Rank 0 writes ``items`` (key in the file, tensor name, this rank's
    tensor) to ``file`` in key order, each shard gathered over ``axis``
    just before it is written, cast to ``dtype`` and reshaped to
    ``shapes[key]`` where given; every rank takes part in the gathers."""
    n = comm.axis_size(axis)
    items = sorted(items, key=lambda item: item[0])
    shapes = shapes or {}

    def tensors():
        for key, name, t in items:
            if name in sharded:
                t = comm.all_gather(t, axis, sharded[name])
            if dtype is not None:
                t = t.to(dtype)
            yield t.reshape(shapes[key]) if key in shapes else t

    if comm.rank != 0:
        for t in tensors():
            # wait for each gather before queueing the next: queued ahead
            # of the writer, every gathered copy would stay allocated on
            # this rank's card until the writer reached it
            if t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
        return
    entries = []
    for key, name, t in items:
        shape = list(t.shape)
        if name in sharded:
            shape[sharded[name]] *= n
        entries.append((key, dtype or t.dtype,
                        tuple(shapes.get(key, shape))))
    save_stream(file, entries, tensors(), metadata)


@torch.no_grad()
def export_wan_mesh_safetensors(path: str, model: nn.Module,
                                comm=None) -> None:
    """``export_wan_safetensors`` streamed, for a mesh rank's sharded DiT
    (a collective call) or, with no ``comm``, for one process: the
    reference-layout fp32 file, written by rank 0 one gathered tensor at
    a time."""
    from ..models.wan_convert import wan_key_map

    named, sharded, axis, comm = _mesh_layout(model, comm)
    keys = wan_key_map(model.cfg)
    _stream_gathered(path, comm, axis, sharded,
                     [(ref, port, named[port]) for ref, port, _ in keys],
                     dtype=torch.float32,
                     shapes={ref: tuple(shape) for ref, _, shape in keys
                             if shape})


def _restore_opt(path, named, optimizer, cut, generator) -> None:
    """The optimizer's state from ``opt_state.safetensors``, one tensor
    at a time (``cut`` keeps the rank's slice of a shard's), and
    ``generator``'s where the file has one."""
    file = os.path.join(path, OPT_FILE)
    meta = read_metadata(file)
    index = _opt_index(named, optimizer)
    state = optimizer.state_dict()  # the optimizer's own tensors
    if (state["acc"] is not None) != (meta.get("acc") == "True"):
        raise ValueError(f"checkpoint {path}: gradient accumulation in the "
                         "optimizer state does not match this optimizer's")
    for k in _MOMENTS:
        for name in named if state[k] is not None else ():
            state[k][index[name]].copy_(
                cut(name, load_tensor(file, f"{k}/{name}")))
    optimizer.count = int(meta["count"])
    optimizer.mini_step = int(meta["mini_step"])
    if generator is not None and "generator" in meta:
        generator.set_state(torch.tensor(
            list(bytes.fromhex(meta["generator"])), dtype=torch.uint8))


@torch.no_grad()
def restore_checkpoint(path: str, params: Union[nn.Module, Tensors],
                       optimizer=None, comm=None,
                       generator: Optional[torch.Generator] = None) -> int:
    """Load a checkpoint dir into ``params`` (a model's parameters, or
    named tensors such as a template's ``lora_state_dict``) and
    ``optimizer`` when given and saved, and ``generator`` where the
    optimizer's file holds its state; returns its step. Every tensor
    must be in the file with its shape, and the file may hold nothing
    else. With ``comm`` (every rank of a mesh calls it) each tensor is
    read alone and the rank keeps its slice of each shard it holds."""
    from ..utils.safetensors import tensor_names

    named, sharded, axis, comm = _mesh_layout(params, comm)
    n, i = comm.axis_size(axis), comm.axis_index(axis)
    file = os.path.join(path, PARAMS_FILE)

    def cut(name, t):
        if name not in sharded:
            return t
        dim = sharded[name]
        c = t.shape[dim] // n
        return t.narrow(dim, i * c, c)

    saved = set(tensor_names(file))
    if saved != set(named):
        raise ValueError(
            f"checkpoint {path}: parameters differ from the model's "
            f"(missing {sorted(set(named) - saved)[:4]}, unexpected "
            f"{sorted(saved - set(named))[:4]})")
    for name, p in named.items():
        t = cut(name, load_tensor(file, name))
        if t.shape != p.shape:
            raise ValueError(f"checkpoint {path}: {name} has shape "
                             f"{tuple(t.shape)} here, the model "
                             f"{tuple(p.shape)}")
        p.copy_(t)
    if optimizer is not None and os.path.exists(os.path.join(path,
                                                             OPT_FILE)):
        _restore_opt(path, named, optimizer, cut, generator)
    return read_meta(path).get("step", 0)


# ----------------------------------------------- LoRA adapters, peft layout

LORA_EXPORT_NAME = "lora_adapter.safetensors"
ADAPTER_CONFIG = "adapter_config.json"
_PEFT_KEY = re.compile(r"blocks\.(\d+)\.(.+)\.lora_([AB])\.weight$")


def lora_to_peft_state_dict(adapters) -> Dict[str, torch.Tensor]:
    """Adapters (``training/lora.py``) → the JAX package's peft-layout
    state dict (checkpoint.py:176-197): ``<linear>.lora_A.weight`` [r,
    d_in] and ``.lora_B.weight`` [d_out, r], unscaled, fp32 on the CPU,
    under the reference key names (``blocks.{i}.self_attn.q``)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, ad in adapters.items():
        sd[f"{path}.lora_A.weight"] = ad.A.detach().float().t().cpu()
        sd[f"{path}.lora_B.weight"] = ad.B.detach().float().t().cpu()
    return sd


def lora_from_peft_state_dict(sd: Tensors, dtype=torch.float32,
                              device=None):
    """Inverse of ``lora_to_peft_state_dict``: adapters (unscaled) from
    peft-layout keys. Every key must be ``blocks.{i}.<module>.lora_{A|B}.
    weight``, with no prefix: a key that is not raises, where the JAX
    loader skips it (and returns nothing for a prefixed file such as
    ``base_model.model.blocks...``)."""
    from .lora import LoRAAdapter

    per_path: Dict[str, Dict[str, torch.Tensor]] = collections.defaultdict(
        dict)
    bad = []
    for key, val in sd.items():
        m = _PEFT_KEY.match(key)
        if not m:
            bad.append(key)
            continue
        path = f"blocks.{int(m.group(1))}.{m.group(2)}"
        per_path[path][m.group(3)] = val
    if bad or not per_path:
        raise ValueError(
            "not a peft-layout LoRA state dict of the DiT (keys "
            "'blocks.{i}.<module>.lora_{A|B}.weight', no prefix): "
            f"{len(bad)} other key(s), e.g. {sorted(bad)[:4]}")
    adapters = {}
    for path in sorted(per_path, key=lambda p: (int(p.split(".")[1]), p)):
        ab = per_path[path]
        if set(ab) != {"A", "B"}:
            raise ValueError(f"{path}: lora_A and lora_B must both be given")
        a, b = ab["A"].t(), ab["B"].t()  # [d_in, r], [r, d_out]
        ad = LoRAAdapter(a.shape[0], b.shape[1], a.shape[1], dtype, device)
        with torch.no_grad():
            ad.A.copy_(a)
            ad.B.copy_(b)
        adapters[path] = ad
    return adapters


def export_lora_safetensors(path: str, adapters, alpha: float,
                            rank: int) -> None:
    """Write the adapters as peft-layout safetensors and, beside them,
    ``adapter_config.json`` with ``lora_alpha``, ``r``, ``peft_type`` and
    the sorted ``target_modules`` (``self_attn/q`` ...), as the JAX
    ``export_lora_safetensors`` does."""
    save_file(lora_to_peft_state_dict(adapters), path)
    targets = sorted({p.split(".", 2)[2].replace(".", "/")
                      for p in adapters})
    with open(os.path.join(os.path.dirname(path), ADAPTER_CONFIG), "w") as f:
        json.dump({"lora_alpha": alpha, "r": rank, "peft_type": "LORA",
                   "target_modules": targets}, f)
