"""Carry weights from the JAX package's parameter trees into the port.

The trees are nested dicts of arrays (numpy, or anything ``np.asarray``
takes): the output of ``moviigen_tpu``'s ``init_params`` or checkpoint
converters. Layouts change on the way:

- dense ``kernel [in, out]`` → ``nn.Linear.weight [out, in]``;
- conv ``[kt, kh, kw, I, O]`` / ``[kh, kw, I, O]`` → ``[O, I, kt, kh, kw]``
  / ``[O, I, kh, kw]``;
- block leaves stacked as ``[num_layers, ...]`` → one module per layer.

bf16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not
take) cross as their raw 16-bit words.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .models.t5 import T5Encoder
from .models.wan_model import WanModel


def to_torch(a, device=None) -> torch.Tensor:
    """An array as a tensor of the same dtype (bf16 included)."""
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


@torch.no_grad()
def _set(param: torch.Tensor, value) -> None:
    value = to_torch(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit "
                         f"{tuple(param.shape)}")
    param.copy_(value)


def _linear(lin: nn.Linear, p: Dict[str, Any], layer=None) -> None:
    kernel, bias = p["kernel"], p.get("bias")
    if layer is not None:
        kernel = kernel[layer]
        bias = None if bias is None else bias[layer]
    _set(lin.weight, np.asarray(kernel).T)
    if bias is not None:
        _set(lin.bias, bias)


def load_wan_params(model: WanModel, params: Dict[str, Any]) -> WanModel:
    """JAX DiT tree (``wan_model.init_params`` layout) → ``model``."""
    _linear(model.patch_embedding, params["patch_embedding"])
    _linear(model.text_embedding_fc1, params["text_embedding"]["fc1"])
    _linear(model.text_embedding_fc2, params["text_embedding"]["fc2"])
    _linear(model.time_embedding_fc1, params["time_embedding"]["fc1"])
    _linear(model.time_embedding_fc2, params["time_embedding"]["fc2"])
    _linear(model.time_projection, params["time_projection"]["fc"])
    _linear(model.head, params["head"]["head"])
    _set(model.head_modulation, params["head"]["modulation"])
    bp = params["blocks"]
    for i, blk in enumerate(model.blocks):
        for name in ("self_attn", "cross_attn"):
            mod, p = getattr(blk, name), bp[name]
            for proj in ("q", "k", "v", "o"):
                _linear(getattr(mod, proj), p[proj], i)
            if mod.norm_q is not None:
                _set(mod.norm_q, np.asarray(p["norm_q"]["scale"])[i])
                _set(mod.norm_k, np.asarray(p["norm_k"]["scale"])[i])
        _linear(blk.ffn_fc1, bp["ffn"]["fc1"], i)
        _linear(blk.ffn_fc2, bp["ffn"]["fc2"], i)
        _set(blk.modulation, np.asarray(bp["modulation"])[i])
        if blk.norm3_weight is not None:
            _set(blk.norm3_weight, np.asarray(bp["norm3"]["scale"])[i])
            _set(blk.norm3_bias, np.asarray(bp["norm3"]["bias"])[i])
    return model


def load_t5_params(model: T5Encoder, params: Dict[str, Any]) -> T5Encoder:
    """JAX umT5 encoder tree (``t5.init_params`` layout) → ``model``."""
    _set(model.token_embedding, params["token_embedding"])
    _set(model.norm, params["norm"]["weight"])
    bp = params["blocks"]
    for i, blk in enumerate(model.blocks):
        _set(blk.norm1, np.asarray(bp["norm1"]["weight"])[i])
        _set(blk.norm2, np.asarray(bp["norm2"]["weight"])[i])
        for proj in ("q", "k", "v", "o"):
            _set(getattr(blk, proj).weight,
                 np.asarray(bp["attn"][proj])[i].T)
        for proj in ("gate", "fc1", "fc2"):
            _set(getattr(blk, proj).weight, np.asarray(bp["ffn"][proj])[i].T)
        _set(blk.pos_embedding, np.asarray(bp["pos_embedding"])[i])
    return model


def vae_params_to_torch(params: Any, device=None) -> Any:
    """JAX VAE tree (``vae.init_params`` layout) → the port's tree: the
    same nesting, conv ``kernel`` leaves as ``weight`` in PyTorch
    layout."""
    if isinstance(params, dict):
        out = {}
        for key, val in params.items():
            if key == "kernel":
                k = np.asarray(val)
                perm = (4, 3, 0, 1, 2) if k.ndim == 5 else (3, 2, 0, 1)
                out["weight"] = to_torch(k.transpose(perm), device)
            else:
                out[key] = vae_params_to_torch(val, device)
        return out
    if isinstance(params, (list, tuple)):
        return [vae_params_to_torch(v, device) for v in params]
    return to_torch(params, device)
