"""Load and export the DiT in the reference checkpoint layout.

Counterpart of ``moviigen_tpu/models/wan_convert.py`` (``load_wan_checkpoint``,
``expected_wan_keys``) and of the export half of
``moviigen_tpu/training/checkpoint.py`` (``wan_params_to_state_dict``).
Keys follow the reference module tree (``blocks.N.self_attn.q.weight``
…) as the diffusers ``diffusion_pytorch_model*.safetensors`` shards
store them. The port's ``WanModel`` keeps ``nn.Linear`` weights in the
same ``[out, in]`` layout, so only three kinds of tensor change shape:
the patch-embed Conv3d ``[D, C, pt, ph, pw]`` is the Linear
``[D, C·pt·ph·pw]`` (patchify orders a patch as (C, pt, ph, pw)), and the
block and head modulations drop their leading 1.

Loading is strict: every checkpoint key must be consumed
(``models/census.py``), as the JAX converter's ``strict=True``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from ..configs import WanModelConfig
from ..utils.safetensors import load_sharded, save_file
from ..ops.quantization import (QuantLinear, quantize_linear,
                                quantize_linear_int4)
from .census import TrackedStateDict
from .wan_model import WanModel

SHARD_PATTERN = "diffusion_pytorch_model*.safetensors"
EXPORT_NAME = "diffusion_pytorch_model.safetensors"

# (reference key, port parameter name, reference shape or None = the port's)
KeyMap = List[Tuple[str, str, Optional[Tuple[int, ...]]]]


def wan_key_map(cfg: WanModelConfig) -> KeyMap:
    """Every reference key of the t2v or i2v DiT beside the port parameter
    that holds it (the reference ``WanModel`` tree, wan/modules/model.py;
    for i2v also the cross-attention's ``k_img``, ``v_img`` and
    ``norm_k_img`` and the ``img_emb.proj`` MLP, the JAX
    wan_convert.py:95-96, 146-160, 205-208)."""
    d = cfg.dim
    img = cfg.model_type == "i2v"
    pairs: KeyMap = []

    def lin(ref: str, port: str) -> None:
        pairs.append((f"{ref}.weight", f"{port}.weight", None))
        pairs.append((f"{ref}.bias", f"{port}.bias", None))

    pairs.append(("patch_embedding.weight", "patch_embedding.weight",
                  (d, cfg.in_dim, *cfg.patch_size)))
    pairs.append(("patch_embedding.bias", "patch_embedding.bias", None))
    lin("text_embedding.0", "text_embedding_fc1")
    lin("text_embedding.2", "text_embedding_fc2")
    lin("time_embedding.0", "time_embedding_fc1")
    lin("time_embedding.2", "time_embedding_fc2")
    lin("time_projection.1", "time_projection")
    lin("head.head", "head")
    pairs.append(("head.modulation", "head_modulation", (1, 2, d)))
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            with_img = img and attn == "cross_attn"
            projs = ("q", "k", "v", "o") + (("k_img", "v_img") if with_img
                                            else ())
            for proj in projs:
                lin(f"{pre}.{attn}.{proj}", f"{pre}.{attn}.{proj}")
            if cfg.qk_norm:
                norms = ("norm_q", "norm_k") + (("norm_k_img",) if with_img
                                                else ())
                for norm in norms:
                    pairs.append((f"{pre}.{attn}.{norm}.weight",
                                  f"{pre}.{attn}.{norm}", None))
        lin(f"{pre}.ffn.0", f"{pre}.ffn_fc1")
        lin(f"{pre}.ffn.2", f"{pre}.ffn_fc2")
        pairs.append((f"{pre}.modulation", f"{pre}.modulation", (1, 6, d)))
        if cfg.cross_attn_norm:
            pairs.append((f"{pre}.norm3.weight", f"{pre}.norm3_weight", None))
            pairs.append((f"{pre}.norm3.bias", f"{pre}.norm3_bias", None))
    if img:
        for ref, port in (("0", "norm1"), ("4", "norm2")):
            pairs.append((f"img_emb.proj.{ref}.weight",
                          f"img_emb_{port}_weight", None))
            pairs.append((f"img_emb.proj.{ref}.bias",
                          f"img_emb_{port}_bias", None))
        lin("img_emb.proj.1", "img_emb_fc1")
        lin("img_emb.proj.3", "img_emb_fc2")
    return pairs


def expected_wan_keys(cfg: WanModelConfig) -> set:
    """The exact checkpoint key set ``load_wan_state_dict`` consumes."""
    return {ref for ref, _, _ in wan_key_map(cfg)}


@torch.no_grad()
def load_wan_state_dict(model: WanModel, sd: Mapping[str, torch.Tensor],
                        strict: bool = True) -> WanModel:
    """Copy a reference-layout state dict into ``model`` (each tensor cast
    to its parameter's dtype and device). ``strict`` refuses keys that no
    parameter consumes; a missing key always raises. A block linear that
    is a ``QuantLinear`` (``WanModel(quant=...)``) is quantized as it
    loads, from its weight cast to the model's linear dtype, so the
    full-precision model never exists on the device."""
    cfg = model.cfg
    tracked = TrackedStateDict(sd, f"WanModel[{cfg.model_type}] checkpoint")
    params = dict(model.named_parameters())
    for ref, port, ref_shape in wan_key_map(cfg):
        value = tracked[ref]
        if port not in params:  # a QuantLinear's weight or bias
            owner, _, attr = port.rpartition(".")
            _load_quantized(model.get_submodule(owner), attr, value, ref)
            continue
        param = params[port]
        want = ref_shape or tuple(param.shape)
        if tuple(value.shape) != tuple(want):
            raise ValueError(f"checkpoint key {ref!r}: shape "
                             f"{tuple(value.shape)}, the config needs "
                             f"{tuple(want)}")
        param.copy_(value.reshape(param.shape))
    if strict:
        tracked.check_all_consumed()
    return model


def _load_quantized(lin: QuantLinear, attr: str, value: torch.Tensor,
                    ref: str) -> None:
    want = (lin.out_features, lin.in_features) if attr == "weight" \
        else (lin.out_features,)
    if tuple(value.shape) != want:
        raise ValueError(f"checkpoint key {ref!r}: shape "
                         f"{tuple(value.shape)}, the config needs {want}")
    if attr == "bias":
        lin.bias.copy_(value)
        return
    w = value.to(lin.scale.device, lin.bias.dtype)
    if lin.bits == 8:
        q, scale = quantize_linear(w)
    else:
        q, scale = quantize_linear_int4(w, lin.group)
    lin.qweight.copy_(q)
    lin.scale.copy_(scale)


def wan_params_to_state_dict(model: WanModel) -> Dict[str, torch.Tensor]:
    """``model``'s parameters under the reference key names and shapes,
    fp32 on the CPU (the JAX ``wan_params_to_state_dict``)."""
    params = dict(model.named_parameters())
    sd = {}
    for ref, port, ref_shape in wan_key_map(model.cfg):
        t = params[port].detach().float().cpu()
        sd[ref] = t.reshape(ref_shape) if ref_shape else t
    return sd


def load_wan_checkpoint(ckpt_dir: str, cfg: WanModelConfig,
                        dtype: torch.dtype = torch.bfloat16,
                        device=None, strict: bool = True,
                        quant: Optional[str] = None) -> WanModel:
    """A ``WanModel`` with the weights of the
    ``diffusion_pytorch_model*.safetensors`` shards in ``ckpt_dir``
    (the diffusers ``from_pretrained`` layout). Linear weights are
    ``dtype``; the fp32 islands stay fp32, as in ``WanModel``. With
    ``quant`` the block linears are quantized one by one as they load
    (``load_wan_state_dict``)."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"checkpoint dir {ckpt_dir} does not exist")
    sd = load_sharded(ckpt_dir, SHARD_PATTERN)
    model = WanModel(cfg, dtype=dtype, device="meta", quant=quant)
    model = model.to_empty(device=device or "cpu")
    return load_wan_state_dict(model, sd, strict=strict)


def export_wan_safetensors(path: str, model: WanModel) -> None:
    """Write ``model`` as one reference-layout fp32 safetensors file."""
    save_file(wan_params_to_state_dict(model), path)
