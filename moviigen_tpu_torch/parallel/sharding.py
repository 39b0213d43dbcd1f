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
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
from torch import nn

from .comm import Axis, Comm

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


def _replace(module: nn.Module, name: str, tensor: torch.Tensor) -> None:
    if name in module._parameters:
        module._parameters[name] = nn.Parameter(tensor, requires_grad=False)
    else:
        module._buffers[name] = tensor


def shard_params(module: nn.Module, spec: Spec, comm: Comm,
                 axis: Axis) -> nn.Module:
    """This rank's copy of ``module``: each tensor named in ``spec`` cut
    into ``comm.axis_size(axis)`` equal slices along its dim, the slice
    ``comm.axis_index(axis)`` kept (a copy, so the full tensor can go);
    the other tensors shared with ``module``. Each module that holds
    shards records them (``_shard_dims``) for ``make_param_gather``."""
    n, i = comm.axis_size(axis), comm.axis_index(axis)

    def visit(new, prefix):
        dims = {}
        for name, t in list(new._parameters.items()) \
                + list(new._buffers.items()):
            dim = spec.get(prefix + name)
            if dim is None or t is None:
                continue
            if t.shape[dim] % n:
                raise ValueError(f"{prefix}{name}: dim {dim} of "
                                 f"{tuple(t.shape)} does not split over "
                                 f"{n} ranks")
            c = t.shape[dim] // n
            _replace(new, name, t.detach().narrow(dim, i * c, c).clone())
            dims[name] = dim
        if dims:
            new.__dict__["_shard_dims"] = dims

    return _rebuild(module, visit)


def make_param_gather(comm: Comm, axis: Axis
                      ) -> Callable[[nn.Module], nn.Module]:
    """The ``param_gather_fn`` for modules made by ``shard_params``: a
    copy of the given module (a DiT or T5 block, the T5 token table) with
    every shard it holds all-gathered over ``axis`` into the full tensor,
    the same bytes as before the cut; a module without shards is returned
    as it is. Every rank must gather the same modules in the same order."""

    def gather(module: nn.Module) -> nn.Module:
        if not any("_shard_dims" in m.__dict__ for m in module.modules()):
            return module

        def visit(new, prefix):
            dims = new.__dict__.pop("_shard_dims", None)
            for name, dim in (dims or {}).items():
                t = new._parameters.get(name)
                if t is None:
                    t = new._buffers[name]
                _replace(new, name, comm.all_gather(t, axis, dim))

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
