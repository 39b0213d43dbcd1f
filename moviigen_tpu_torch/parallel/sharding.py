"""Parameters held as shards at rest and gathered per block.

Counterpart of ``moviigen_tpu/parallel/sharding.py``: ``dit_param_specs``
(``:42-76``), ``t5_param_specs`` (``:79-109``) and
``shard_pipeline_params`` (``:174-187``). The JAX package gives each leaf
a ``PartitionSpec`` over the sequence axes and gathers a block's leaves
just before the block runs (``ulysses.py:176-197``); here a spec is the
dimension a tensor is cut along, ``shard_params`` gives each rank a copy
of the module that holds its slice of every such tensor (the others are
shared, not copied), and ``make_param_gather`` returns the
``param_gather_fn`` that the DiT's ``run_blocks`` and the T5 encoder call
on each block: it all-gathers the block's shards into a full copy, which
is dropped once the block has run.

The rules, on PyTorch's ``[out, in]`` weights (JAX's kernels are
``[in, out]``):

- q, k, v, k_img, v_img and fc1 / gate: the output dimension (0);
- o and fc2: the input dimension (1);
- quantized codes and scales (``QuantLinear.qweight`` / ``scale``): the
  output dimension, so int8 and packed int4 bytes move as they are;
- the umT5's int8 token table (``QuantEmbedding``): its rows;
- biases, norms, modulations, embeddings and the head: replicated. The
  VAE is replicated.

A gather over the comm (rather than FSDP2 or DTensor) runs over
``ThreadComm`` on one card as it runs over NCCL, and moves the quantized
buffers without a wrapper.

Training (the JAX ``shard_map`` transpose of the same gathers):

- A shard of a trained tensor is the leaf ``nn.Parameter`` the optimizer
  holds (``requires_grad`` as the full tensor had it). The gathered full
  weight is a non-leaf tensor tied to the shard by the gather's autograd
  op, whose backward reduce-scatters the block's gradient (a sum over the
  shard axes) into the shard's; the shard first passes
  ``Comm.replicate`` over ``data``, whose backward sums the data ranks'
  gradients. The DiT's ``run_blocks`` gathers inside the checkpointed
  block, so under remat the full weights are gathered again in the
  backward, never saved.
- A trained tensor that is not cut (a bias, a norm scale, a modulation,
  a LoRA adapter) passes ``Comm.replicate`` over the whole mesh on its
  way into the block: every rank's gradient of it is then the sum of all
  ranks', the whole gradient, as for the tensors used only before or
  after the stack (embeddings, head), which every rank computes alike.
- Quantized codes and scales stay frozen buffers, gathered as they are.
- Optimizer state: there is no counterpart of the JAX
  ``opt_state_specs`` (``moviigen_tpu/parallel/sharding.py:112-150``).
  The port's ``AdamW`` keeps its moments beside each parameter it is
  given, so a rank's optimizer over its sharded model's parameters holds
  moments of each shard's shape: the optimizer state is sharded as the
  weights are, with nothing to lay out.
- Every shard is marked (``is_shard``), so that the optimizer's clip
  can count it once over the shard axes (``train_step.mesh_global_norm``).
- Thread ranks share every tensor that is not cut (``_rebuild``); the
  ranks that train take their own copies of those they train
  (``comm.own_trained``).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
from torch import nn

from .comm import AXES, Axis, Comm

Spec = Dict[str, int]  # tensor name → the dimension it is cut along

_ATTN_OUT = ("q", "k", "v", "k_img", "v_img")
_DIT_QUANT = _ATTN_OUT + ("o", "ffn_fc1", "ffn_fc2")
_T5_QUANT = ("q", "k", "v", "o", "gate", "fc1", "fc2")


def _named_tensors(module: nn.Module):
    yield from module.named_parameters()
    yield from module.named_buffers()


def dit_param_specs(model: nn.Module) -> Spec:
    """The DiT's sharded tensors (``WanModel`` names) and their dims."""
    spec = {}
    for name, _ in _named_tensors(model):
        path = name.split(".")
        if path[0] != "blocks" or len(path) < 4:
            continue
        owner, leaf = path[-2], path[-1]
        if leaf in ("qweight", "scale") and owner in _DIT_QUANT:
            spec[name] = 0
        elif leaf == "weight":
            if owner == "ffn_fc1" or (owner in _ATTN_OUT and path[-3] in (
                    "self_attn", "cross_attn")):
                spec[name] = 0
            elif owner == "ffn_fc2" or (owner == "o" and path[-3] in (
                    "self_attn", "cross_attn")):
                spec[name] = 1
    return spec


def t5_param_specs(model: nn.Module) -> Spec:
    """The umT5 encoder's sharded tensors (``T5Encoder`` names) and their
    dims."""
    spec = {}
    for name, _ in _named_tensors(model):
        path = name.split(".")
        if path[0] == "token_embedding" and len(path) == 2:
            spec[name] = 0  # the int8 table's rows (codes and scales)
        elif path[0] == "blocks" and len(path) == 4:
            owner, leaf = path[-2], path[-1]
            if leaf in ("qweight", "scale") and owner in _T5_QUANT:
                spec[name] = 0
            elif leaf == "weight" and owner in ("q", "k", "v", "gate",
                                                "fc1"):
                spec[name] = 0
            elif leaf == "weight" and owner in ("o", "fc2"):
                spec[name] = 1
    return spec


def _rebuild(module: nn.Module, visit: Callable[[nn.Module, str], None],
             prefix: str = "") -> nn.Module:
    """A copy of the module tree that shares every tensor with
    ``module`` until ``visit(copy, qualified name prefix)``, called on
    each copied module, replaces it; ``module`` itself is not changed, so
    ranks that share it (thread ranks) may copy it at once."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {k: None if m is None else _rebuild(m, visit,
                                                       f"{prefix}{k}.")
                    for k, m in module._modules.items()}
    visit(new, prefix)
    return new


def _replace(module: nn.Module, name: str, tensor: torch.Tensor,
             requires_grad: bool = False) -> torch.Tensor:
    if name in module._parameters:
        tensor = nn.Parameter(tensor, requires_grad=requires_grad)
        module._parameters[name] = tensor
    else:
        module._buffers[name] = tensor
    return tensor


def shard_params(module: nn.Module, spec: Spec, comm: Comm,
                 axis: Axis) -> nn.Module:
    """This rank's copy of ``module``: each tensor named in ``spec`` cut
    into ``comm.axis_size(axis)`` equal slices along its dim, the slice
    ``comm.axis_index(axis)`` kept (a copy, so the full tensor can go; a
    parameter keeps its ``requires_grad``; marked, see ``is_shard``); the
    other tensors shared with ``module``. Each module that holds shards
    records them (``_shard_dims``) for ``make_param_gather``."""
    n, i = comm.axis_size(axis), comm.axis_index(axis)

    def visit(new, prefix):
        dims = {}
        for name, t in list(new._parameters.items()) \
                + list(new._buffers.items()):
            dim = None if t is None else spec.get(prefix + name)
            if dim is None:
                continue
            if t.shape[dim] % n:
                raise ValueError(f"{prefix}{name}: dim {dim} of "
                                 f"{tuple(t.shape)} does not split over "
                                 f"{n} ranks")
            c = t.shape[dim] // n
            _replace(new, name, t.detach().narrow(dim, i * c, c).clone(),
                     t.requires_grad)._shard_dim = dim
            dims[name] = dim
        if dims:
            new.__dict__["_shard_dims"] = dims

    return _rebuild(module, visit)


def is_shard(t: torch.Tensor) -> bool:
    """Whether ``t`` is a slice that ``shard_params`` cut."""
    return getattr(t, "_shard_dim", None) is not None


def sharded_tensors(module: nn.Module) -> Spec:
    """The qualified names of the shards ``module`` holds (made by
    ``shard_params``) and the dims they were cut along."""
    return {f"{prefix}.{name}" if prefix else name: dim
            for prefix, m in module.named_modules()
            for name, dim in m.__dict__.get("_shard_dims", {}).items()}


def _trained(module: nn.Module) -> bool:
    return torch.is_grad_enabled() and any(
        p.requires_grad for p in module.parameters())


def make_param_gather(comm: Comm, axis: Axis
                      ) -> Callable[[nn.Module], nn.Module]:
    """The ``param_gather_fn`` for modules made by ``shard_params``: a
    copy of the given module (a DiT or T5 block, the T5 token table) with
    every shard it holds all-gathered over ``axis`` into the full tensor,
    the same bytes as before the cut. Under autograd the gathered weights
    stay tied to their shards, and every other tensor that requires grad
    passes ``Comm.replicate`` over the whole mesh (see the module's
    docstring). A module with no shards and nothing to train is returned
    as it is. Every rank must gather the same modules in the same order."""
    others = tuple(a for a in AXES if a not in Comm._axes(axis))

    def gather(module: nn.Module) -> nn.Module:
        trained = _trained(module)
        if not trained and not any("_shard_dims" in m.__dict__
                                   for m in module.modules()):
            return module

        def visit(new, prefix):
            dims = new.__dict__.pop("_shard_dims", None) or {}
            for name, dim in dims.items():
                t = new._parameters.get(name)
                if t is None:
                    _replace(new, name,
                             comm.all_gather(new._buffers[name], axis, dim))
                elif trained and t.requires_grad:
                    # a non-leaf tied to the shard: the gradient flows back
                    new._parameters[name] = comm.all_gather(
                        comm.replicate(t, others), axis, dim)
                else:
                    _replace(new, name, comm.all_gather(t, axis, dim))
            if trained:
                for name, t in new._parameters.items():
                    if name not in dims and t is not None \
                            and t.requires_grad:
                        new._parameters[name] = comm.replicate(t, AXES)

        return _rebuild(module, visit)

    return gather


def shard_axis(comm: Comm) -> Axis:
    """The axes parameters are sharded over: ``seq``, or ``ring`` ×
    ``seq`` on a hybrid USP mesh."""
    return ("ring", "seq") if "ring" in comm.axis_names else "seq"


def shard_pipeline_params(comm: Comm, t5: nn.Module, vae_params,
                          dit: nn.Module):
    """The pipeline's three models for ``comm``'s rank: the umT5 encoder
    and the DiT as shards over the sequence axes, the VAE replicated."""
    axis = shard_axis(comm)
    return (shard_params(t5, t5_param_specs(t5), comm, axis), vae_params,
            shard_params(dit, dit_param_specs(dit), comm, axis))
