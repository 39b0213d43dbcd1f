"""Mesh construction: the ``(data, ring, seq)`` comm over the world's ranks.

Counterpart of ``moviigen_tpu/parallel/mesh.py``. The axes are the JAX
package's:

- ``data``: the CFG pair (cond, uncond) split over ranks;
- ``seq``: sequence parallelism (the Ulysses all-to-all axis), which is
  also the axis the parameters are sharded over at rest;
- ``ring``: with ``ring > 1``, the K/V rotation axis of the hybrid
  Ulysses × ring mode, placed outside ``seq`` so each ring block's tokens
  are contiguous.

``make_mesh`` and ``make_pod_mesh`` lay the mesh over the ranks of the
``torch.distributed`` world (``maybe_initialize_distributed`` first) and
return this process' ``DistComm``; ``comm.thread_mesh`` builds the same
mesh from threads of one process.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from .comm import Comm, DistComm


def _world_size() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call parallel.distributed."
                           "maybe_initialize_distributed() first (torchrun)")
    return dist.get_world_size()


def make_mesh(data: int = 1, seq: int = 1, ring: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Optional[DistComm]:
    """A ``(data, seq)`` — with ``ring > 1``, ``(data, ring, seq)`` — mesh
    over the first ``data·ring·seq`` ranks of the world (or over
    ``ranks``), data outermost. Every process must call it; a rank outside
    the mesh gets None."""
    world = _world_size()
    n = data * seq * ring
    if n > world:
        raise ValueError(f"mesh {data}x{ring}x{seq} needs {n} ranks, "
                         f"have {world}")
    return DistComm.build(data, ring, seq,
                          list(range(n)) if ranks is None else list(ranks))


def mesh_axis_size(mesh: Optional[Comm], axis: str) -> int:
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]


def make_pod_mesh(data: int = 1, seq: int = 1, ring: int = 1,
                  num_slices: Optional[int] = None
                  ) -> Optional[DistComm]:
    """The multi-node mesh: ``data`` spans the nodes, ``ring`` and ``seq``
    (a collective every block) stay within one node's cards, as the JAX
    ``make_pod_mesh`` keeps them within a TPU slice. ``num_slices``
    defaults to the number of nodes of the torchrun launch (world size
    over ``LOCAL_WORLD_SIZE``). With one node this is ``make_mesh``."""
    world = per_node = None
    if num_slices is None:
        world = _world_size()
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_slices = max(1, world // per_node)
    if num_slices <= 1:
        return make_mesh(data=data, seq=seq, ring=ring)
    if data % num_slices != 0:
        raise ValueError(
            f"data axis {data} must be a multiple of num_slices "
            f"{num_slices} (each slice carries data/num_slices DP ranks)")
    if world is None:
        world = _world_size()
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    per_slice = data // num_slices * ring * seq
    if per_slice > per_node:
        raise ValueError(f"mesh {data}x{ring}x{seq} needs {per_slice} ranks "
                         f"on each of {num_slices} nodes, have {per_node}")
    ranks = [s * per_node + i for s in range(num_slices)
             for i in range(per_slice)]
    return DistComm.build(data, ring, seq, ranks)
