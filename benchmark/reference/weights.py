"""The benchmark's weights, drawn from ``--seed``: what every leaf of the
Wan DiT, the umT5 encoder and the Wan VAE decoder is, and its values.

Leaves are named as the port names its parameters (``WanModel``'s and
``T5Encoder``'s ``named_parameters``, the VAE tree's keys joined by dots),
so that the harness can copy them into the program by name. They come in
groups: a block of the DiT or of the encoder, the rest of either, and the
VAE. Each group is one ``torch.randn`` over all of its leaves from a
generator seeded by (seed, model, group) on the device, shaped and scaled
per leaf and rounded to the type the leaf is served in. So the reference
can draw any group again on its own, and the program and the reference
hold the same numbers.

The distributions follow the models' own initialisations (xavier for the
DiT's linears, the T5 standard deviations, He-like convolutions), with
three changes so that no part of a random model is silent: the DiT's head
and the VAE's attention projection, which those initialisations zero, are
drawn like the other linears; biases, norm scales and norm shifts are
drawn around their usual values; the AdaLN modulations have a standard
deviation of 0.1, so each block's gates pass a tenth of its output on.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str]  # (name, shape, served dtype)


def _lin(name: str, cin: int, cout: int, dtype: str,
         bias: bool = True) -> List[Spec]:
    out = [(f"{name}.weight", (cout, cin), dtype)]
    if bias:
        out.append((f"{name}.bias", (cout,), dtype))
    return out


def dit_specs(m: dict, dtype: str = "bfloat16",
              islands: str = "float32") -> List[Spec]:
    """Every leaf of the t2v DiT of the ``model`` group ``m``: the block
    linears and the patch and text embeddings in ``dtype``; the time
    embedding, modulations, norms and head in ``islands`` (fp32 in
    serving; a full fine-tune holds everything in fp32)."""
    d, f = m["dim"], m["ffn_dim"]
    patch_in = m["in_dim"] * math.prod(m["patch_size"])
    specs = (_lin("patch_embedding", patch_in, d, dtype)
             + _lin("text_embedding_fc1", m["text_dim"], d, dtype)
             + _lin("text_embedding_fc2", d, d, dtype)
             + _lin("time_embedding_fc1", m["freq_dim"], d, islands)
             + _lin("time_embedding_fc2", d, d, islands)
             + _lin("time_projection", d, 6 * d, islands))
    for i in range(m["num_layers"]):
        b = f"blocks.{i}"
        for site in ("self_attn", "cross_attn"):
            for p in ("q", "k", "v", "o"):
                specs += _lin(f"{b}.{site}.{p}", d, d, dtype)
            if m["qk_norm"]:
                specs += [(f"{b}.{site}.norm_q", (d,), islands),
                          (f"{b}.{site}.norm_k", (d,), islands)]
        specs += _lin(f"{b}.ffn_fc1", d, f, dtype)
        specs += _lin(f"{b}.ffn_fc2", f, d, dtype)
        specs.append((f"{b}.modulation", (6, d), islands))
        if m["cross_attn_norm"]:
            specs += [(f"{b}.norm3_weight", (d,), islands),
                      (f"{b}.norm3_bias", (d,), islands)]
    specs += _lin("head", d, math.prod(m["patch_size"]) * m["out_dim"],
                  islands)
    specs.append(("head_modulation", (2, d), islands))
    return specs


def dit_init(m: dict) -> Callable[[str, tuple], Tuple[float, float]]:
    def init(name: str, shape: tuple) -> Tuple[float, float]:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) == 2:
            if name.startswith(("text_embedding", "time_embedding")):
                return 0.0, 0.02
            return 0.0, math.sqrt(2.0 / (shape[0] + shape[1]))
        if leaf == "bias" or leaf == "norm3_bias":
            return 0.0, 0.02
        if leaf in ("modulation", "head_modulation"):
            return 0.0, 0.1
        if leaf in ("norm_q", "norm_k", "norm3_weight"):
            return 1.0, 0.05
        raise KeyError(f"no distribution for DiT leaf {name}")
    return init


def t5_specs(t: dict, dtype: str = "bfloat16") -> List[Spec]:
    """Every leaf of the umT5 encoder of the ``t5`` group ``t`` (no
    biases; per-block relative position tables in fp32)."""
    d, da, df = t["dim"], t["dim_attn"], t["dim_ffn"]
    specs: List[Spec] = [("token_embedding", (t["vocab_size"], d), dtype),
                         ("norm", (d,), dtype)]
    for i in range(t["num_layers"]):
        b = f"blocks.{i}"
        specs += [(f"{b}.norm1", (d,), dtype), (f"{b}.norm2", (d,), dtype),
                  (f"{b}.q.weight", (da, d), dtype),
                  (f"{b}.k.weight", (da, d), dtype),
                  (f"{b}.v.weight", (da, d), dtype),
                  (f"{b}.o.weight", (d, da), dtype),
                  (f"{b}.gate.weight", (df, d), dtype),
                  (f"{b}.fc1.weight", (df, d), dtype),
                  (f"{b}.fc2.weight", (d, df), dtype),
                  (f"{b}.pos_embedding", (t["num_buckets"], t["num_heads"]),
                   "float32")]
    return specs


def t5_init(t: dict) -> Callable[[str, tuple], Tuple[float, float]]:
    d, da, df, n = t["dim"], t["dim_attn"], t["dim_ffn"], t["num_heads"]
    std = {"q": (d * da) ** -0.5, "k": d ** -0.5, "v": d ** -0.5,
           "o": da ** -0.5, "gate": d ** -0.5, "fc1": d ** -0.5,
           "fc2": df ** -0.5}

    def init(name: str, shape: tuple) -> Tuple[float, float]:
        parts = name.split(".")
        if name == "token_embedding":
            return 0.0, 1.0
        if parts[-1] in ("norm", "norm1", "norm2"):
            return 1.0, 0.05
        if parts[-1] == "pos_embedding":
            return 0.0, (2 * t["num_buckets"] * n) ** -0.5
        if parts[-1] == "weight" and parts[-2] in std:
            return 0.0, std[parts[-2]]
        raise KeyError(f"no distribution for T5 leaf {name}")
    return init


def _conv(name, kt, kh, kw, cin, cout, two_d=False) -> List[Spec]:
    shape = (cout, cin, kh, kw) if two_d else (cout, cin, kt, kh, kw)
    return [(f"{name}.weight", shape, "float32"),
            (f"{name}.bias", (cout,), "float32")]


def _res(name, cin, cout) -> List[Spec]:
    specs = [(f"{name}.norm1.gamma", (cin,), "float32")]
    specs += _conv(f"{name}.conv1", 3, 3, 3, cin, cout)
    specs += [(f"{name}.norm2.gamma", (cout,), "float32")]
    specs += _conv(f"{name}.conv2", 3, 3, 3, cout, cout)
    if cin != cout:
        specs += _conv(f"{name}.shortcut", 1, 1, 1, cin, cout)
    return specs


def vae_specs(v: dict) -> List[Spec]:
    """Every leaf of the Wan VAE's decoding half (``conv2`` and
    ``decoder``) for the ``vae`` group ``v``, in fp32, named by the
    port's tree keys (the layout of ``models/vae.py::init_params`` at
    commit 503dac0, frozen here)."""
    dim, mult = v["dim"], tuple(v["dim_mult"])
    ddims = [dim * u for u in (mult[-1],) + tuple(reversed(mult))]
    up_time = tuple(reversed(v["temporal_downsample"]))
    specs = _conv("conv2", 1, 1, 1, v["z_dim"], v["z_dim"])
    specs += _conv("decoder.conv1", 3, 3, 3, v["z_dim"], ddims[0])
    specs += _res("decoder.mid_res1", ddims[0], ddims[0])
    specs += [("decoder.mid_attn.norm.gamma", (ddims[0],), "float32")]
    specs += _conv("decoder.mid_attn.to_qkv", 1, 1, 1, ddims[0],
                   3 * ddims[0], two_d=True)
    specs += _conv("decoder.mid_attn.proj", 1, 1, 1, ddims[0], ddims[0],
                   two_d=True)
    specs += _res("decoder.mid_res2", ddims[0], ddims[0])
    for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
        if i in (1, 2, 3):
            cin = cin // 2
        c = cin
        for r in range(v["num_res_blocks"] + 1):
            specs += _res(f"decoder.up.{i}.res.{r}", c, cout)
            c = cout
        if i != len(mult) - 1:
            specs += _conv(f"decoder.up.{i}.upsample.conv", 1, 3, 3, cout,
                           cout // 2, two_d=True)
            if up_time[i]:
                specs += _conv(f"decoder.up.{i}.upsample.time_conv", 3, 1,
                               1, cout, cout * 2)
    specs += [("decoder.head_norm.gamma", (ddims[-1],), "float32")]
    specs += _conv("decoder.head_conv", 3, 3, 3, ddims[-1], 3)
    return specs


def vae_init(name: str, shape: tuple) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight":
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "bias":
        return 0.0, 0.02
    if leaf == "gamma":
        return 1.0, 0.05
    raise KeyError(f"no distribution for VAE leaf {name}")


def group_of(model: str, name: str) -> str:
    """The group a leaf is drawn in: ``blocks.<i>`` for a block's leaves,
    ``rest`` for the others of the DiT and the encoder, ``all`` for the
    VAE."""
    if model == "vae":
        return "all"
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "blocks" else "rest"


def group_specs(model: str, specs: Sequence[Spec]) -> Dict[str, List[Spec]]:
    """The specs by group, each group's leaves in name order (so that the
    draw does not depend on the order a module registers them)."""
    out: Dict[str, List[Spec]] = {}
    for s in specs:
        out.setdefault(group_of(model, s[0]), []).append(s)
    return {g: sorted(v) for g, v in out.items()}


def group_seed(seed: int, model: str, group: str) -> int:
    h = hashlib.sha256(f"{seed}:{model}:{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


@torch.no_grad()
def draw_group(seed: int, model: str, group: str, specs: Sequence[Spec],
               init, device) -> Dict[str, torch.Tensor]:
    """One group's leaves, name → tensor in its served dtype, from a single
    ``randn`` on ``device``."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(
        group_seed(seed, model, group))
    z = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for name, shape, dtype in specs:
        n = math.prod(shape)
        mean, std = init(name, shape)
        leaf = z[off:off + n].view(shape) * std
        if mean:
            leaf = leaf + mean
        out[name] = leaf.to(getattr(torch, dtype))
        off += n
    return out


def draw_all(seed: int, model: str, specs: Sequence[Spec], init,
             device) -> Iterator[Dict[str, torch.Tensor]]:
    """Every group of a model in turn (one group in memory at a time)."""
    for group, gs in group_specs(model, specs).items():
        yield draw_group(seed, model, group, gs, init, device)
