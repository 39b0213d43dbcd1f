"""The harness's side of the program under test (``moviigen_tpu_torch``):
its configuration built from a configuration file, and the benchmark's
weights (``reference/weights.py``) copied into its modules by name.
Nothing here computes what the program computes.
"""

from __future__ import annotations

import dataclasses

import torch

from .reference import weights as W


def pipeline_config(conf: dict):
    """The port's ``PipelineConfig`` holding the file's sizes: its
    ``model``, ``t5`` and ``vae`` groups replace the registry entry's
    (``conf["task"]``) field by field, and so do the top-level keys the
    config names."""
    from moviigen_tpu_torch.configs import (WAN_CONFIGS, T5Config, VAEConfig,
                                            WanModelConfig)

    def tuples(group):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in group.items()}

    base = WAN_CONFIGS[conf["task"]]
    top = {f.name for f in dataclasses.fields(base)}
    extra = {k: tuple(v) if isinstance(v, list) else v
             for k, v in conf.items() if k in top
             and k not in ("name", "model", "t5", "vae")}
    return base.replace(
        model=WanModelConfig(**tuples(conf["model"])),
        t5=T5Config(**tuples(conf["t5"])),
        vae=VAEConfig(**tuples(conf["vae"])), **extra)


def _check_and_copy(params: dict, drawn: dict, what: str) -> None:
    for name, value in drawn.items():
        p = params.get(name)
        if p is None:
            raise KeyError(f"{what}: the program has no leaf {name}")
        if tuple(p.shape) != tuple(value.shape) or p.dtype != value.dtype:
            raise ValueError(
                f"{what}.{name}: the program holds {tuple(p.shape)} "
                f"{p.dtype}, the benchmark draws {tuple(value.shape)} "
                f"{value.dtype}")
        p.copy_(value)


def _same_names(have, specs, what: str) -> None:
    want = {s[0] for s in specs}
    if set(have) != want:
        raise ValueError(f"{what}: leaves differ from the benchmark's: "
                         f"missing {sorted(want - set(have))[:5]}, "
                         f"extra {sorted(set(have) - want)[:5]}")


@torch.no_grad()
def load_module(module: torch.nn.Module, model: str, specs, init,
                seed: int) -> None:
    """Every leaf of ``module`` drawn from the seed, group by group on the
    module's device."""
    params = dict(module.named_parameters())
    _same_names(params, specs, model)
    device = next(module.parameters()).device
    for group in W.draw_all(seed, model, specs, init, device):
        _check_and_copy(params, group, model)


def flat_tree(tree, prefix: str = "") -> dict:
    """The VAE's nested dict and list of tensors as dotted names."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, torch.Tensor):
            out[name] = v
        else:
            out.update(flat_tree(v, name + "."))
    return out


@torch.no_grad()
def load_pipeline(pipe, conf: dict, seed: int) -> None:
    """The DiT, the umT5 encoder and the VAE decoder of a ``WanT2V``."""
    m, t, v = conf["model"], conf["t5"], conf["vae"]
    load_module(pipe.dit, "dit", W.dit_specs(m, conf["param_dtype"]),
                W.dit_init(m), seed)
    load_module(pipe.t5, "t5", W.t5_specs(t, conf["t5_dtype"]),
                W.t5_init(t), seed)
    leaves = flat_tree(pipe.vae_params)
    specs = W.vae_specs(v)
    _same_names(leaves, specs, "vae")
    device = next(iter(leaves.values())).device
    for group in W.draw_all(seed, "vae", specs, W.vae_init, device):
        _check_and_copy(leaves, group, "vae")
