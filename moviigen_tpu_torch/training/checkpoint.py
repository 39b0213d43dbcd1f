"""Checkpoint save/restore, the reference-layout export and the LoRA
adapters' peft-layout export.

Counterpart of ``moviigen_tpu/training/checkpoint.py``: the layout
``<output_dir>/checkpoint-step_N/`` that the validation watcher scans
(ref ``valid_training.py:302-313``), with

- ``params.safetensors``: the trained tensors under the port's names
  (``utils/safetensors.py``): the model's parameters, or for a LoRA run
  the adapters alone (``lora.lora_state_dict``);
- ``opt_state.pt``: the optimizer state (``torch.save``; read back with
  ``weights_only=True``);
- ``meta.json``: ``{"step": N}`` plus the caller's keys (the CLI adds
  ``final``, ``lora`` and ``quant``, and for LoRA ``lora_rank``,
  ``lora_alpha`` and ``lora_dtype``, as the JAX CLI does);
- with ``export_safetensors``, ``diffusion_pytorch_model.safetensors``
  in the reference's diffusers key names (fp32), which both packages'
  ``load_wan_checkpoint`` read; for a LoRA run
  ``lora_adapter.safetensors`` and ``adapter_config.json`` instead
  (``export_lora_safetensors``).
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
from ..utils.safetensors import load_file, save_file

CKPT_RE = re.compile(r"checkpoint-step_(\d+)$")
PARAMS_FILE = "params.safetensors"
OPT_FILE = "opt_state.pt"

__all__ = ["CKPT_RE", "checkpoint_dir", "latest_checkpoint",
           "save_checkpoint", "restore_checkpoint", "read_meta",
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


def save_checkpoint(output_dir: str, step: int,
                    params: Union[nn.Module, Tensors], optimizer=None,
                    extra_meta: Optional[Dict[str, Any]] = None,
                    export_safetensors: bool = False) -> str:
    """Write ``checkpoint-step_{step}``: ``params`` (a model, whose
    parameters are saved, or named tensors such as the adapters'
    ``lora_state_dict``), the optimizer state and ``meta.json``; with
    ``export_safetensors`` also the model in the reference layout (a
    model only)."""
    path = checkpoint_dir(output_dir, step)
    os.makedirs(path, exist_ok=True)
    save_file(_named(params), os.path.join(path, PARAMS_FILE))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, OPT_FILE))
    meta = {"step": step}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if export_safetensors:
        if not isinstance(params, nn.Module):
            raise TypeError("export_safetensors writes a model; adapters go "
                            "through export_lora_safetensors")
        export_wan_safetensors(os.path.join(path, EXPORT_NAME), params)
    return path


def read_meta(path: str) -> Dict[str, Any]:
    """A checkpoint dir's ``meta.json`` (empty if it has none)."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


@torch.no_grad()
def restore_checkpoint(path: str, params: Union[nn.Module, Tensors],
                       optimizer=None) -> int:
    """Load a checkpoint dir into ``params`` (a model's parameters, or
    named tensors such as a template's ``lora_state_dict``) and
    ``optimizer`` when given and saved; returns its step. Every tensor
    must be in the file with its shape, and the file may hold nothing
    else."""
    saved = load_file(os.path.join(path, PARAMS_FILE))
    params = _named(params)
    if set(saved) != set(params):
        raise ValueError(
            f"checkpoint {path}: parameters differ from the model's "
            f"(missing {sorted(set(params) - set(saved))[:4]}, unexpected "
            f"{sorted(set(saved) - set(params))[:4]})")
    for name, p in params.items():
        if saved[name].shape != p.shape:
            raise ValueError(f"checkpoint {path}: {name} has shape "
                             f"{tuple(saved[name].shape)}, the model "
                             f"{tuple(p.shape)}")
        p.copy_(saved[name])
    opt_path = os.path.join(path, OPT_FILE)
    if optimizer is not None and os.path.exists(opt_path):
        device = next(iter(params.values())).device
        optimizer.load_state_dict(torch.load(opt_path, map_location=device,
                                             weights_only=True))
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
