"""Checkpoint save/restore and the reference-layout export.

Counterpart of ``moviigen_tpu/training/checkpoint.py``: the layout
``<output_dir>/checkpoint-step_N/`` that the validation watcher scans
(ref ``valid_training.py:302-313``), with

- ``params.safetensors``: the model's parameters under the port's names
  (``utils/safetensors.py``);
- ``opt_state.pt``: the optimizer state (``torch.save``; read back with
  ``weights_only=True``);
- ``meta.json``: ``{"step": N}`` plus the caller's keys (the CLI adds
  ``final``, ``lora`` and ``quant``, as the JAX CLI does);
- with ``export_safetensors``, ``diffusion_pytorch_model.safetensors``
  in the reference's diffusers key names (fp32), which both packages'
  ``load_wan_checkpoint`` read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.wan_convert import (EXPORT_NAME, export_wan_safetensors,
                                  wan_params_to_state_dict)
from ..utils.safetensors import load_file, save_file

CKPT_RE = re.compile(r"checkpoint-step_(\d+)$")
PARAMS_FILE = "params.safetensors"
OPT_FILE = "opt_state.pt"

__all__ = ["CKPT_RE", "checkpoint_dir", "latest_checkpoint",
           "save_checkpoint", "restore_checkpoint",
           "wan_params_to_state_dict", "export_wan_safetensors"]


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


def save_checkpoint(output_dir: str, step: int, model: nn.Module,
                    optimizer=None,
                    extra_meta: Optional[Dict[str, Any]] = None,
                    export_safetensors: bool = False) -> str:
    path = checkpoint_dir(output_dir, step)
    os.makedirs(path, exist_ok=True)
    save_file(dict(model.named_parameters()),
              os.path.join(path, PARAMS_FILE))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, OPT_FILE))
    meta = {"step": step}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if export_safetensors:
        export_wan_safetensors(os.path.join(path, EXPORT_NAME), model)
    return path


@torch.no_grad()
def restore_checkpoint(path: str, model: nn.Module, optimizer=None) -> int:
    """Load a checkpoint dir into ``model`` (and ``optimizer`` when given
    and saved); returns its step. Every parameter must be in the file
    with its shape, and the file may hold nothing else."""
    saved = load_file(os.path.join(path, PARAMS_FILE))
    params = dict(model.named_parameters())
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
    step = 0
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            step = json.load(f).get("step", 0)
    return step
