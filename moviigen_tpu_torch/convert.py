"""Carry weights between the JAX package's parameter trees and the port.

The trees are nested dicts of arrays (numpy, torch tensors, or anything
``np.asarray`` takes): the output of ``moviigen_tpu``'s ``init_params``,
checkpoint converters or quantizers. Layouts change on the way:

- dense ``kernel [in, out]`` → ``nn.Linear.weight [out, in]``;
- quantized ``q8 [in, out]`` / ``q4 [in // 2, out]`` with ``scale [out]``
  / ``[in // g, out]`` → ``QuantLinear.qweight [out, in]`` /
  ``[out, in // 2]`` with ``scale [out]`` / ``[out, in // g]`` (this one
  transpose is why the int8 GEMM reads both operands along K); the ``a8``
  marker becomes ``QuantLinear.act8``;
- conv ``[kt, kh, kw, I, O]`` / ``[kh, kw, I, O]`` → ``[O, I, kt, kh, kw]``
  / ``[O, I, kh, kw]``;
- block leaves stacked as ``[num_layers, ...]`` → one module per layer;
- LoRA adapters ``{"blocks/self_attn/q": {"A": [L, d_in, r], "B": [L, r,
  d_out]}}`` → one ``LoRAAdapter`` per targeted linear and layer, A and B
  in the same [d_in, r] / [r, d_out] layout.

``wan_params_tree`` and ``t5_params_tree`` go the other way (torch
tensors in the JAX layout): the quantized caches on disk are such trees,
so that either package reads the other's file.

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
from .ops.quantization import (T5_TARGETS, TARGET_SUFFIXES, QuantEmbedding,
                               QuantLinear, block_linear)


def to_torch(a, device=None) -> torch.Tensor:
    """An array as a tensor of the same dtype (bf16 included)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.array(a, order="C")  # a writable copy
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _t(a):
    """The last two axes swapped (numpy array or tensor)."""
    return a.swapaxes(-1, -2)


@torch.no_grad()
def _set(param: torch.Tensor, value) -> None:
    value = to_torch(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit "
                         f"{tuple(param.shape)}")
    param.copy_(value)


def _leaf(p, layer):
    """A block leaf's entries, sliced to one layer."""
    if not isinstance(p, dict):
        p = {"kernel": p}  # the T5 tree keeps bare kernels
    return p if layer is None else {k: v[layer] for k, v in p.items()}


def _linear(lin: nn.Module, p, layer=None) -> None:
    p = _leaf(p, layer)
    code = "q8" if "q8" in p else "q4" if "q4" in p else None
    if code is None:
        if not isinstance(lin, nn.Linear):
            raise TypeError("a full-precision leaf does not fit a "
                            f"{type(lin).__name__}")
        _set(lin.weight, _t(p["kernel"]))
    else:
        if not (isinstance(lin, QuantLinear) and lin.bits == int(code[1])
                and lin.act8 == ("a8" in p)):
            raise TypeError(f"a {code} leaf (a8: {'a8' in p}) does not fit "
                            f"{lin!r}")
        _set(lin.qweight, _t(p[code]))
        _set(lin.scale, p["scale"] if code == "q8" else _t(p["scale"]))
    if p.get("bias") is not None and lin.bias is not None:
        _set(lin.bias, p["bias"])


def _linear_leaf(lin: nn.Module) -> Dict[str, torch.Tensor]:
    """One layer's leaf of the JAX tree for ``lin`` (inverse of
    ``_linear``)."""
    if isinstance(lin, QuantLinear):
        if lin.bits == 8:
            out = {"q8": _t(lin.qweight), "scale": lin.scale}
            if lin.act8:
                out["a8"] = torch.ones((), dtype=torch.int8,
                                       device=lin.scale.device)
        else:
            out = {"q4": _t(lin.qweight), "scale": _t(lin.scale)}
    else:
        out = {"kernel": _t(lin.weight.detach())}
    if lin.bias is not None:
        out["bias"] = lin.bias.detach()
    return out


def _stack(leaves):
    """Per-layer leaves (dicts of tensors, or tensors) stacked over a
    leading layer axis."""
    if isinstance(leaves[0], dict):
        return {k: torch.stack([leaf[k] for leaf in leaves])
                for k in leaves[0]}
    return torch.stack([leaf.detach() for leaf in leaves])


def load_wan_params(model: WanModel, params: Dict[str, Any]) -> WanModel:
    """JAX DiT tree (``wan_model.init_params`` layout, block linears
    full-precision or quantized) → ``model``, whose block linears must be
    of the same kind (``WanModel(quant=...)``)."""
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
        for suffix in TARGET_SUFFIXES:
            group, name = suffix.split("/")
            if name in bp[group]:
                owner, attr = block_linear(blk, suffix)
                _linear(getattr(owner, attr), bp[group][name], i)
        for name in ("self_attn", "cross_attn"):
            mod, p = getattr(blk, name), bp[name]
            if mod.norm_q is not None:
                _set(mod.norm_q, p["norm_q"]["scale"][i])
                _set(mod.norm_k, p["norm_k"]["scale"][i])
        _set(blk.modulation, bp["modulation"][i])
        if blk.norm3_weight is not None:
            _set(blk.norm3_weight, bp["norm3"]["scale"][i])
            _set(blk.norm3_bias, bp["norm3"]["bias"][i])
    return model


def wan_params_tree(model: WanModel) -> Dict[str, Any]:
    """``model`` as a JAX DiT tree of tensors on the model's device
    (inverse of ``load_wan_params``)."""
    blocks: Dict[str, Any] = {"self_attn": {}, "cross_attn": {}, "ffn": {}}
    for suffix in TARGET_SUFFIXES:
        group, name = suffix.split("/")
        owner, attr = block_linear(model.blocks[0], suffix)
        if hasattr(owner, attr):
            blocks[group][name] = _stack([
                _linear_leaf(getattr(*block_linear(blk, suffix)))
                for blk in model.blocks])
    for name in ("self_attn", "cross_attn"):
        if model.blocks[0].self_attn.norm_q is not None:
            for norm in ("norm_q", "norm_k"):
                blocks[name][norm] = {"scale": _stack(
                    [getattr(getattr(blk, name), norm)
                     for blk in model.blocks])}
    blocks["modulation"] = _stack([blk.modulation for blk in model.blocks])
    if model.blocks[0].norm3_weight is not None:
        blocks["norm3"] = {
            "scale": _stack([blk.norm3_weight for blk in model.blocks]),
            "bias": _stack([blk.norm3_bias for blk in model.blocks])}
    return {
        "patch_embedding": _linear_leaf(model.patch_embedding),
        "text_embedding": {"fc1": _linear_leaf(model.text_embedding_fc1),
                           "fc2": _linear_leaf(model.text_embedding_fc2)},
        "time_embedding": {"fc1": _linear_leaf(model.time_embedding_fc1),
                           "fc2": _linear_leaf(model.time_embedding_fc2)},
        "time_projection": {"fc": _linear_leaf(model.time_projection)},
        "blocks": blocks,
        "head": {"head": _linear_leaf(model.head),
                 "modulation": model.head_modulation.detach()},
    }


def lora_params_to_torch(lora: Dict[str, Any]):
    """The JAX LoRA tree (``training/lora.py::init_lora_params``:
    ``{"blocks/self_attn/q": {"A": [L, d_in, r], "B": [L, r, d_out]}}``)
    → the port's adapters (``{"blocks.{i}.self_attn.q": LoRAAdapter}``,
    block by block in the order of ``DEFAULT_TARGETS``), in the tree's
    dtype, on the CPU."""
    from .training.lora import DEFAULT_TARGETS, LoRAAdapter

    adapters = {}
    stacks = {}
    for base, ab in lora.items():
        head, _, suffix = base.partition("/")
        if head != "blocks":
            raise ValueError(f"LoRA target {base!r} is not a block linear")
        a, b = to_torch(ab["A"]), to_torch(ab["B"])
        if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
            raise ValueError(f"{base}: A {tuple(a.shape)} and B "
                             f"{tuple(b.shape)} are not stacked layers")
        stacks[suffix.replace("/", ".")] = (a, b)
    order = [t.partition("/")[2].replace("/", ".") for t in DEFAULT_TARGETS]
    stacks = dict(sorted(stacks.items(), key=lambda kv: (
        order.index(kv[0]) if kv[0] in order else len(order), kv[0])))
    layers = {a.shape[0] for a, _ in stacks.values()}
    if len(layers) != 1:
        raise ValueError(f"LoRA targets stack different layer counts: "
                         f"{sorted(layers)}")
    for i in range(layers.pop()):
        for suffix, (a, b) in stacks.items():
            ad = LoRAAdapter(a.shape[1], b.shape[2], a.shape[2], a.dtype)
            _set(ad.A, a[i])
            _set(ad.B, b[i])
            adapters[f"blocks.{i}.{suffix}"] = ad
    return adapters


def lora_params_tree(adapters) -> Dict[str, Any]:
    """The port's adapters as the JAX LoRA tree of tensors (inverse of
    ``lora_params_to_torch``): A and B stacked over the blocks, in the
    adapters' dtype."""
    per_target: Dict[str, Dict[int, Any]] = {}
    for path, ad in adapters.items():
        _, layer, suffix = path.split(".", 2)
        per_target.setdefault(f"blocks/{suffix.replace('.', '/')}", {})[
            int(layer)] = ad
    tree = {}
    for base, layers in per_target.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{base}: adapters on layers {sorted(layers)}, "
                             "not on every block")
        ads = [layers[i] for i in range(len(layers))]
        tree[base] = {"A": torch.stack([ad.A.detach() for ad in ads]),
                      "B": torch.stack([ad.B.detach() for ad in ads])}
    return tree


def load_t5_params(model: T5Encoder, params: Dict[str, Any]) -> T5Encoder:
    """JAX umT5 encoder tree (``t5.init_params`` layout, linears and
    token embedding full-precision or quantized) → ``model``, built with
    the same ``quant_bits``."""
    emb = params["token_embedding"]
    if isinstance(emb, dict):
        if not isinstance(model.token_embedding, QuantEmbedding):
            raise TypeError("a quantized token embedding needs "
                            "T5Encoder(quant_bits=...)")
        _set(model.token_embedding.qweight, emb["q8"])
        _set(model.token_embedding.scale, emb["scale"])
    else:
        _set(model.token_embedding, emb)
    _set(model.norm, params["norm"]["weight"])
    bp = params["blocks"]
    for i, blk in enumerate(model.blocks):
        _set(blk.norm1, bp["norm1"]["weight"][i])
        _set(blk.norm2, bp["norm2"]["weight"][i])
        for target in T5_TARGETS:
            group, name = target.split("/")
            _linear(getattr(blk, name), bp[group][name], i)
        _set(blk.pos_embedding, bp["pos_embedding"][i])
    return model


def t5_params_tree(model: T5Encoder) -> Dict[str, Any]:
    """``model`` as a JAX umT5 encoder tree of tensors (inverse of
    ``load_t5_params``)."""
    blocks: Dict[str, Any] = {"attn": {}, "ffn": {}}
    for target in T5_TARGETS:
        group, name = target.split("/")
        leaf = _stack([_linear_leaf(getattr(blk, name))
                       for blk in model.blocks])
        blocks[group][name] = leaf["kernel"] if "kernel" in leaf else leaf
    for norm in ("norm1", "norm2"):
        blocks[norm] = {"weight": _stack([getattr(blk, norm)
                                          for blk in model.blocks])}
    blocks["pos_embedding"] = _stack([blk.pos_embedding
                                      for blk in model.blocks])
    emb = model.token_embedding
    if isinstance(emb, QuantEmbedding):
        emb = {"q8": emb.qweight, "scale": emb.scale}
    else:
        emb = emb.detach()
    return {"token_embedding": emb, "blocks": blocks,
            "norm": {"weight": model.norm.detach()}}


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
