"""Collectives over the named axes of a device mesh.

Counterpart of the JAX package's ``jax.sharding.Mesh`` and of the
collectives its ``shard_map`` bodies call (``moviigen_tpu/parallel/
mesh.py``, ``ulysses.py``, ``ring.py``). There one program runs over the
mesh; here every rank runs the same Python code and holds a ``Comm`` that
answers the same calls over the axes ``data``, ``ring`` and ``seq``:

- ``axis_index(axis)`` and ``axis_size(axis)``;
- ``all_to_all(x, axis, split_dim, concat_dim)``: x is split along
  ``split_dim`` into as many chunks as the axis has ranks, chunk j goes to
  rank j, and the chunks received are concatenated along ``concat_dim`` in
  rank order (``jax.lax.all_to_all(..., tiled=True)``);
- ``ring_shift(x, axis)``: x goes to the next rank of the axis and the
  previous rank's x comes back (``jax.lax.ppermute`` with
  ``perm = [(i, (i + 1) % n)]``);
- ``all_gather(x, axis, dim)``: the axis' tensors concatenated along
  ``dim`` in rank order (``jax.lax.all_gather(..., tiled=True)``).

``axis`` is one name or a tuple of names taken jointly, the first one
outer: ``("ring", "seq")`` is the token axis of the hybrid Ulysses × ring
mesh. The layout is the JAX package's (``mesh.py:27-50``, the devices
reshaped to ``(data, ring, seq)``): a rank's mesh position is
``(d·R + r)·U + s`` for data index d, ring index r and seq index s, so a
rank's token block over ``("ring", "seq")`` is ``r·U + s``.

Two implementations answer the same calls:

- ``DistComm``: one process per rank, ``torch.distributed`` sub-groups per
  axis (``all_to_all_single``, ``batch_isend_irecv``, the all-gather into
  one tensor); NCCL on the card, gloo on the CPU;
- ``ThreadComm``: the ranks are threads of one process meeting at a
  barrier over a shared slot table, the counterpart of the JAX package's
  virtual CPU devices. It is how one card runs a mesh of several ranks,
  which NCCL refuses.

Every rank must make the same collective calls in the same order (the
code is SPMD, as the JAX package's ``shard_map`` bodies are).
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...]]
AXES = ("data", "ring", "seq")


def _split_to_front(x: torch.Tensor, n: int, split_dim: int) -> torch.Tensor:
    """x with ``split_dim`` cut into n chunks, the chunk index moved to
    the front: [n, ...] contiguous, chunk j at [j]."""
    shape = list(x.shape)
    if shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split into {n} chunks")
    shape[split_dim:split_dim + 1] = [n, shape[split_dim] // n]
    return x.reshape(shape).movedim(split_dim, 0).contiguous()


def _merge_from_front(y: torch.Tensor, concat_dim: int) -> torch.Tensor:
    """The inverse layout of ``_split_to_front``: y [n, ...] with the
    chunks laid side by side along ``concat_dim`` in index order."""
    y = y.movedim(0, concat_dim)
    shape = list(y.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                        * shape[concat_dim + 1]]
    return y.reshape(shape).contiguous()


class Comm:
    """A rank's place in a ``(data, ring, seq)`` mesh; the collectives
    are its subclasses'. ``axis_names`` is ``("data", "seq")``, or
    ``("data", "ring", "seq")`` with ``ring > 1``, as the JAX
    ``make_mesh`` names its axes; an absent axis has size 1."""

    def __init__(self, data: int, ring: int, seq: int, rank: int):
        for name, n in (("data", data), ("ring", ring), ("seq", seq)):
            if n < 1:
                raise ValueError(f"mesh axis {name} must be >= 1, got {n}")
        self.sizes = {"data": data, "ring": ring, "seq": seq}
        self.axis_names = AXES if ring > 1 else ("data", "seq")
        self.shape = {a: self.sizes[a] for a in self.axis_names}
        self.size = data * ring * seq
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.rank = rank
        self.coords = {"data": rank // (ring * seq),
                       "ring": rank // seq % ring, "seq": rank % seq}

    @staticmethod
    def _axes(axis: Axis) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r} (axes: {AXES})")
        return axes

    def axis_size(self, axis: Axis) -> int:
        return math.prod(self.sizes[a] for a in self._axes(axis))

    def axis_index(self, axis: Axis) -> int:
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.sizes[a] + self.coords[a]
        return idx

    def group(self, axis: Axis) -> List[int]:
        """The mesh positions of this rank's group along ``axis``, in the
        order of their ``axis_index``."""
        return self.positions(axis, self.coords)

    def positions(self, axis: Axis, coords) -> List[int]:
        """The mesh positions along ``axis`` with the other axes at
        ``coords``."""
        axes = self._axes(axis)
        out = []
        for combo in itertools.product(*(range(self.sizes[a])
                                          for a in axes)):
            c = dict(coords)
            c.update(zip(axes, combo))
            out.append((c["data"] * self.sizes["ring"] + c["ring"])
                       * self.sizes["seq"] + c["seq"])
        return out

    # the collectives -------------------------------------------------

    def all_to_all(self, x: torch.Tensor, axis: Axis, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        raise NotImplementedError

    def ring_shift(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, axis: Axis,
                   dim: int) -> torch.Tensor:
        raise NotImplementedError


class DistComm(Comm):
    """A ``Comm`` over ``torch.distributed``: one process per rank.
    ``ranks[p]`` is the global rank at mesh position p; ``groups`` maps
    each axis key (a tuple of names) to this rank's sub-group. Build it
    with ``parallel.mesh.make_mesh``: every process of the world must take
    part in creating the sub-groups."""

    def __init__(self, data: int, ring: int, seq: int, rank: int,
                 ranks: Sequence[int], groups):
        super().__init__(data, ring, seq, rank)
        self.ranks = list(ranks)
        self.groups = groups

    @classmethod
    def build(cls, data: int, ring: int, seq: int,
              ranks: Sequence[int]) -> Optional["DistComm"]:
        """Create every sub-group of a ``(data, ring, seq)`` mesh laid
        over the global ``ranks`` (a collective call of the whole world)
        and return this process' comm, or None where it is not in the
        mesh."""
        import torch.distributed as dist

        me = dist.get_rank()
        probe = Comm(data, ring, seq, 0)
        groups = {}
        for key in (("data",), ("ring",), ("seq",), ("ring", "seq")):
            others = [a for a in AXES if a not in key]
            for combo in itertools.product(*(range(probe.sizes[a])
                                              for a in others)):
                coords = dict.fromkeys(AXES, 0)
                coords.update(zip(others, combo))
                members = [ranks[p] for p in probe.positions(key, coords)]
                group = dist.new_group(members)
                if me in members:
                    groups[key] = group
        if me not in ranks:
            return None
        return cls(data, ring, seq, list(ranks).index(me), ranks, groups)

    def _group(self, axis: Axis):
        return self.groups[self._axes(axis)]

    def all_to_all(self, x, axis, split_dim, concat_dim):
        import torch.distributed as dist

        n = self.axis_size(axis)
        send = _split_to_front(x, n, split_dim)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._group(axis))
        return _merge_from_front(recv, concat_dim)

    def ring_shift(self, x, axis):
        import torch.distributed as dist

        members = [self.ranks[p] for p in self.group(axis)]
        n, i = len(members), self.axis_index(axis)
        send = x.contiguous()
        recv = torch.empty_like(send)
        group = self._group(axis)
        ops = [dist.P2POp(dist.isend, send, members[(i + 1) % n], group),
               dist.P2POp(dist.irecv, recv, members[(i - 1) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def all_gather(self, x, axis, dim):
        import torch.distributed as dist

        n = self.axis_size(axis)
        send = x.movedim(dim, 0).contiguous()
        recv = send.new_empty((n * send.shape[0], *send.shape[1:]))
        dist.all_gather_into_tensor(recv, send, group=self._group(axis))
        return recv.movedim(0, dim).contiguous()


class _Rendezvous:
    """What the threads of one ``ThreadComm`` mesh share: a barrier and
    one slot per rank."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: List[Optional[torch.Tensor]] = [None] * n

    def exchange(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x``, once all ranks have put theirs in."""
        self.slots[rank] = x
        self.barrier.wait()
        view = list(self.slots)
        self.barrier.wait()  # all have read before any writes again
        return view


class ThreadComm(Comm):
    """A ``Comm`` whose ranks are threads of one process (``thread_mesh``,
    ``run_ranks``). A collective puts each rank's tensor in a shared slot
    table, waits at a barrier for the others, and builds its result from
    the slots with ordinary tensor ops (concatenation, slicing, a copy).

    On the card every thread launches on the same stream, the one that
    was current where ``run_ranks`` was called: the order in which the
    threads pass the barrier on the host is then also the order of their
    work on the device, so a rank that reads a peer's tensor after the
    barrier reads it finished, with no event between them."""

    def __init__(self, data: int, ring: int, seq: int, rank: int,
                 rendezvous: _Rendezvous):
        super().__init__(data, ring, seq, rank)
        self._rv = rendezvous

    def _peers(self, x: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
        slots = self._rv.exchange(self.rank, x)
        return [slots[p] for p in self.group(axis)]

    def all_to_all(self, x, axis, split_dim, concat_dim):
        peers = self._peers(x, axis)
        n, i = len(peers), self.axis_index(axis)
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of "
                             f"{tuple(x.shape)} does not split into {n} "
                             "chunks")
        c = x.shape[split_dim] // n
        return torch.cat([p.narrow(split_dim, i * c, c) for p in peers],
                         dim=concat_dim).contiguous()

    def ring_shift(self, x, axis):
        peers = self._peers(x, axis)
        return peers[(self.axis_index(axis) - 1) % len(peers)].clone()

    def all_gather(self, x, axis, dim):
        return torch.cat(self._peers(x, axis), dim=dim).contiguous()


def thread_mesh(data: int = 1, seq: int = 1, ring: int = 1,
                timeout: float = 600.0) -> List[ThreadComm]:
    """A ``(data, ring, seq)`` mesh of thread ranks: one ``ThreadComm``
    per mesh position, in rank order. Drive it with ``run_ranks``."""
    n = data * ring * seq
    rv = _Rendezvous(n, timeout)
    return [ThreadComm(data, ring, seq, r, rv) for r in range(n)]


def run_ranks(fn: Callable[[ThreadComm], object],
              comms: Sequence[ThreadComm]) -> list:
    """``fn(comm)`` for every rank of a ``thread_mesh``, each in a thread
    of its own; returns the results in rank order. The threads take the
    caller's grad mode, CUDA device and current stream (each is per
    thread in PyTorch), so the ranks run after the work that made their
    inputs, on one stream.
    If a rank raises, the barrier is broken so that the others stop too,
    and the first rank's own error is raised here."""
    grad = torch.is_grad_enabled()
    stream = torch.cuda.current_stream() if torch.cuda.is_initialized() \
        else None
    results: list = [None] * len(comms)
    errors: list = [None] * len(comms)

    def body(i):
        try:
            if stream is not None:
                torch.cuda.set_device(stream.device)
            with torch.set_grad_enabled(grad), torch.cuda.stream(stream):
                results[i] = fn(comms[i])
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors[i] = e
            comms[i]._rv.barrier.abort()

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(len(comms))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    own = [e for e in errors if e is not None
           and not isinstance(e, threading.BrokenBarrierError)]
    if own or any(e is not None for e in errors):
        raise (own or [e for e in errors if e is not None])[0]
    return results
