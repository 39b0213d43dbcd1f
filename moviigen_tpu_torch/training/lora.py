"""LoRA adapters on the DiT's attention projections, over a full-precision
or a quantized frozen base (QLoRA).

Counterpart of ``moviigen_tpu/training/lora.py`` (ref ``finetune.py``
``--use_lora``, ``--lora_rank``, ``--lora_alpha``). The maths is the JAX
module's, ``W_eff = W + (alpha/rank) · A @ B``, in two forms:

- ``attach_lora``: each targeted linear gets a ``LoRAAdapter`` child
  module (``<linear>.lora``) holding ``A`` [d_in, r] and ``B`` [r, d_out];
  the DiT's dense ops add the rank-r side path ``out + (x @ A) @ (s·B)``
  after the base GEMM (``LoRAAdapter.side``, the JAX ``_lora_side``).
  The base's tensors are never written, int8/int4 codes included, and
  ``detach_lora`` gives the model back as it was.
- ``merge_lora``: a copy of a full-precision model with the deltas
  folded into its weights.

Adapters are a dict from the targeted linear's module path in the port
(``"blocks.3.self_attn.q"``) to its ``LoRAAdapter``; the JAX package
stacks them over layers (``convert.lora_params_to_torch`` and
``lora_params_tree`` carry them across). Only A and B train.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Iterator, Sequence, Tuple

import torch
from torch import nn

from ..ops.quantization import QuantLinear, block_linear

# The JAX targets (lora.py:28-33): q/k/v/o of the self- and the
# cross-attention; the FFN is not targeted.
DEFAULT_TARGETS = (
    "blocks/self_attn/q", "blocks/self_attn/k",
    "blocks/self_attn/v", "blocks/self_attn/o",
    "blocks/cross_attn/q", "blocks/cross_attn/k",
    "blocks/cross_attn/v", "blocks/cross_attn/o",
)

Adapters = Dict[str, "LoRAAdapter"]


class LoRAAdapter(nn.Module):
    """One linear's adapter: ``A`` [d_in, r] and ``B`` [r, d_out] in the
    adapter dtype. ``scale`` (alpha / rank) is set by ``attach_lora``."""

    def __init__(self, d_in: int, d_out: int, rank: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.A = nn.Parameter(torch.zeros(d_in, rank, dtype=dtype,
                                          device=device))
        self.B = nn.Parameter(torch.zeros(rank, d_out, dtype=dtype,
                                          device=device))
        self.scale = 1.0

    def side(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """``out + (x @ A) @ (scale·B)`` in ``out``'s dtype (the JAX
        ``_lora_side``, wan_model.py:160-171): the scale is applied to B in
        B's dtype, then x, A and the scaled B are cast to ``out.dtype``."""
        cd = out.dtype
        h = torch.matmul(x.to(cd), self.A.to(cd))
        return out + torch.matmul(h, (self.B * self.scale).to(cd))

    def extra_repr(self) -> str:
        (d_in, r), d_out = self.A.shape, self.B.shape[1]
        return f"d_in={d_in}, d_out={d_out}, rank={r}, scale={self.scale}"


def target_paths(model: nn.Module,
                 targets: Sequence[str] = DEFAULT_TARGETS
                 ) -> Iterator[Tuple[str, nn.Module]]:
    """(module path, linear) of every targeted linear of a ``WanModel``,
    block by block in the order of ``targets``."""
    suffixes = []
    for t in targets:
        head, _, suffix = t.partition("/")
        if head != "blocks" or suffix.count("/") != 1:
            raise ValueError(f"LoRA target {t!r} is not a block linear "
                             "('blocks/<attn>/<proj>')")
        suffixes.append(suffix)
    for i, blk in enumerate(model.blocks):
        for suffix in suffixes:
            owner, attr = block_linear(blk, suffix)
            lin = getattr(owner, attr, None)
            if isinstance(lin, (nn.Linear, QuantLinear)):
                yield f"blocks.{i}.{suffix.replace('/', '.')}", lin


@torch.no_grad()
def init_lora_params(model: nn.Module, rank: int = 64,
                     targets: Sequence[str] = DEFAULT_TARGETS,
                     dtype: torch.dtype = torch.float32,
                     generator: torch.Generator = None) -> Adapters:
    """Fresh adapters for ``model``'s targeted linears (``nn.Linear`` or
    ``QuantLinear``, whose shapes are read from the module): A ~ N(0, 1)/r
    drawn from ``generator``, B = 0, as the JAX ``init_lora_params``
    (the numbers differ). Without a generator A is zero too (a template
    to restore into). On the model's device."""
    device = next(model.parameters()).device
    adapters: Adapters = {}
    for path, lin in target_paths(model, targets):
        ad = LoRAAdapter(lin.in_features, lin.out_features, rank, dtype,
                         device)
        if generator is not None:
            ad.A.copy_(torch.randn(ad.A.shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       .to(dtype) * (1.0 / rank))
        adapters[path] = ad
    if not adapters:
        raise ValueError(f"no LoRA targets matched: {targets}")
    return adapters


def lora_parameters(adapters: Adapters) -> Iterable[nn.Parameter]:
    """A and B of every adapter, in the adapters' order (the trainable
    list the optimizer takes)."""
    for ad in adapters.values():
        yield ad.A
        yield ad.B


def lora_state_dict(adapters: Adapters) -> Dict[str, torch.Tensor]:
    """The adapters under the names they take on the model when attached
    (``blocks.3.self_attn.q.lora.A``)."""
    return {f"{path}.lora.{name}": p for path, ad in adapters.items()
            for name, p in (("A", ad.A), ("B", ad.B))}


def attach_lora(model: nn.Module, adapters: Adapters, alpha: float = 64.0,
                rank: int = 64) -> nn.Module:
    """Mount ``adapters`` on ``model``'s linears (in place) with scale
    ``alpha / rank``. Raises if a path is not a linear of the model or
    already carries an adapter."""
    scale = alpha / rank
    for path, ad in adapters.items():
        lin = model.get_submodule(path)
        if not isinstance(lin, (nn.Linear, QuantLinear)):
            raise TypeError(f"{path} is a {type(lin).__name__}, not a linear")
        if "lora" in lin._modules:
            raise ValueError(f"{path} already carries an adapter "
                             "(detach_lora first)")
        if ad.A.shape[0] != lin.in_features \
                or ad.B.shape[1] != lin.out_features:
            raise ValueError(f"{path}: adapter {tuple(ad.A.shape)} @ "
                             f"{tuple(ad.B.shape)} does not fit "
                             f"{lin.in_features} -> {lin.out_features}")
        ad.scale = scale
        lin.lora = ad
    return model


def detach_lora(model: nn.Module) -> Adapters:
    """Take every adapter off ``model`` (in place); returns them."""
    taken: Adapters = {}
    for name, mod in list(model.named_modules()):
        if isinstance(mod, (nn.Linear, QuantLinear)) and "lora" in mod._modules:
            taken[name] = mod._modules.pop("lora")
    return taken


@torch.no_grad()
def merge_lora(model: nn.Module, adapters: Adapters, alpha: float = 64.0,
               rank: int = 64) -> nn.Module:
    """A copy of ``model`` with ``W + ((A @ B)·alpha/rank)ᵀ`` in each
    targeted weight (the JAX ``merge_lora``: the delta in the adapters'
    dtype, cast to the weight's). Full-precision linears only."""
    scale = alpha / rank
    merged = copy.deepcopy(model)
    detach_lora(merged)
    for path, ad in adapters.items():
        lin = merged.get_submodule(path)
        if not isinstance(lin, nn.Linear):
            raise TypeError(f"merge_lora: {path} is a {type(lin).__name__}; "
                            "merging needs a full-precision weight")
        delta = torch.matmul(ad.A, ad.B) * scale
        lin.weight.add_(delta.t().to(lin.weight.dtype))
    return merged
