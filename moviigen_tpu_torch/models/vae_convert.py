"""Load and export the Wan2.1 VAE in the reference checkpoint layout
(``Wan2.1_VAE.pth``, a pickled state dict).

Counterpart of ``moviigen_tpu/models/vae_convert.py``. Keys follow the
reference module tree (``wan/modules/vae.py``): the flat Sequential
indices ``encoder.downsamples.N`` / ``decoder.upsamples.N`` are unflattened
into per-stage lists. The port's tree keeps PyTorch's convolution layouts
(Conv3d ``[O, I, kt, kh, kw]``, Conv2d ``[O, I, kh, kw]``), so no weight
is transposed; RMS-norm gammas ``[C, 1, 1(, 1)]`` flatten to ``[C]``.

Loading is strict: every checkpoint key must be consumed
(``models/census.py``), encoder included, although serving only decodes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch

from ..configs import VAEConfig
from .census import TrackedStateDict

# (reference key, path into the port's tree, trailing 1s of the reference
# shape: gammas only)
KeyMap = List[Tuple[str, Tuple[Any, ...], int]]


def vae_key_map(cfg: VAEConfig) -> KeyMap:
    """Every key of the reference ``WanVAE_`` state dict
    (wan/modules/vae.py:483-616) beside the tree leaf that holds it."""
    pairs: KeyMap = []

    def conv(name, path):
        pairs.append((f"{name}.weight", path + ("weight",), 0))
        pairs.append((f"{name}.bias", path + ("bias",), 0))

    def gamma(name, path, ones=3):
        pairs.append((f"{name}.gamma", path + ("gamma",), ones))

    def res(name, path, has_shortcut):
        gamma(f"{name}.residual.0", path + ("norm1",))
        conv(f"{name}.residual.2", path + ("conv1",))
        gamma(f"{name}.residual.3", path + ("norm2",))
        conv(f"{name}.residual.6", path + ("conv2",))
        if has_shortcut:
            conv(f"{name}.shortcut", path + ("shortcut",))

    def attn(name, path):
        gamma(f"{name}.norm", path + ("norm",), ones=2)
        conv(f"{name}.to_qkv", path + ("to_qkv",))
        conv(f"{name}.proj", path + ("proj",))

    def stages(side, seq, kind, dims, n_res, temporal, halve):
        idx = 0
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            if halve and i in (1, 2, 3):
                cin = cin // 2  # the previous upsample halved the channels
            c = cin
            for j in range(n_res):
                res(f"{side}.{seq}.{idx}", (side, kind, i, "res", j),
                    c != cout)
                c = cout
                idx += 1
            if i != len(cfg.dim_mult) - 1:
                name = f"{side}.{seq}.{idx}"
                path = (side, kind, i, f"{kind}sample")
                conv(f"{name}.resample.1", path + ("conv",))
                if temporal[i]:
                    conv(f"{name}.time_conv", path + ("time_conv",))
                idx += 1

    def middle_and_head(side):
        res(f"{side}.middle.0", (side, "mid_res1"), False)
        attn(f"{side}.middle.1", (side, "mid_attn"))
        res(f"{side}.middle.2", (side, "mid_res2"), False)
        gamma(f"{side}.head.0", (side, "head_norm"))
        conv(f"{side}.head.2", (side, "head_conv"))

    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    conv("encoder.conv1", ("encoder", "conv1"))
    stages("encoder", "downsamples", "down", dims, cfg.num_res_blocks,
           cfg.temporal_downsample, halve=False)
    middle_and_head("encoder")

    ddims = [cfg.dim * u for u in
             (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    conv("decoder.conv1", ("decoder", "conv1"))
    stages("decoder", "upsamples", "up", ddims, cfg.num_res_blocks + 1,
           tuple(reversed(cfg.temporal_downsample)), halve=True)
    middle_and_head("decoder")
    conv("conv1", ("conv1",))
    conv("conv2", ("conv2",))
    return pairs


def expected_vae_keys(cfg: VAEConfig) -> set:
    """The exact checkpoint key set ``convert_vae_state_dict`` consumes."""
    return {ref for ref, _, _ in vae_key_map(cfg)}


def _put(tree: Dict[str, Any], path, value) -> None:
    """``tree[path] = value``, creating dicts (and lists, under an integer
    step) on the way."""
    node = tree
    for step, nxt in zip(path[:-1], path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(step, int):
            while len(node) <= step:
                node.append(None)
            if node[step] is None:
                node[step] = empty
            node = node[step]
        else:
            node = node.setdefault(step, empty)
    node[path[-1]] = value


def _get(tree: Dict[str, Any], path):
    node = tree
    for step in path:
        node = node[step]
    return node


def convert_vae_state_dict(sd: Mapping[str, torch.Tensor], cfg: VAEConfig,
                           dtype: torch.dtype = torch.float32, device=None,
                           strict: bool = True) -> Dict[str, Any]:
    """Reference state dict → the port's tree (``models/vae.py`` layout,
    encoder included), every leaf ``dtype`` on ``device``. ``strict``
    refuses keys the converter does not consume; a missing key always
    raises."""
    tracked = TrackedStateDict(sd, "WanVAE checkpoint")
    tree: Dict[str, Any] = {}
    for ref, path, ones in vae_key_map(cfg):
        value = torch.as_tensor(tracked[ref])
        if ones:
            value = value.reshape(-1)
        _put(tree, path, value.to(device=device, dtype=torch.float32 if ones
                                  else dtype))
    if strict:
        tracked.check_all_consumed()
    return tree


def vae_state_dict(params: Dict[str, Any], cfg: VAEConfig
                   ) -> Dict[str, torch.Tensor]:
    """A full tree (``vae.init_params(..., encoder=True)`` or a converted
    checkpoint) under the reference key names and shapes, fp32 on the
    CPU."""
    sd = {}
    for ref, path, ones in vae_key_map(cfg):
        t = _get(params, path).detach().float().cpu()
        sd[ref] = t.reshape(-1, *([1] * ones)) if ones else t
    return sd


def load_vae_checkpoint(path: str, cfg: VAEConfig,
                        dtype: torch.dtype = torch.float32, device=None,
                        strict: bool = True) -> Dict[str, Any]:
    """``Wan2.1_VAE.pth`` → the port's tree."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_vae_state_dict(sd, cfg, dtype, device, strict=strict)
