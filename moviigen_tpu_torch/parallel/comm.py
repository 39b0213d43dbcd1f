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
  ``dim`` in rank order (``jax.lax.all_gather(..., tiled=True)``);
- ``reduce_scatter(x, axis, dim)``: the axis' tensors summed, then cut
  along ``dim`` and chunk i kept by rank i (``jax.lax.psum_scatter(...,
  tiled=True)``);
- ``all_reduce(x, axis)``: the axis' tensors summed (``jax.lax.psum``).

Each is differentiable, with the backward that JAX's transpose rules
give: the all-to-all's is the reverse all-to-all (split and concat
swapped), the ring shift's a shift the other way, the all-gather's a
reduce-scatter (a sum) and the reduce-scatter's an all-gather; the
all-reduce's is an all-reduce. Three more say how a value crosses
between what every rank holds alike and what each holds of its own, the
transposes of ``shard_map``'s in and out specs:

- ``shard(x, axis, dim)``: this rank's chunk of a value every rank holds
  alike; the backward all-gathers the chunks' gradients;
- ``unshard(x, axis, dim)``: the chunks gathered into the whole for a
  computation every rank then repeats alike (the DiT's head and loss);
  the backward keeps this rank's chunk of the gradient (a sum would
  count the one loss once per rank);
- ``replicate(x, axis)``: x as it is, into computations that differ
  from rank to rank (the block stack's weights, each rank's tokens); the
  backward sums the gradients over the axis.

An axis of size 1 makes every collective the identity.

The ring's shift also comes in an asynchronous form, for the serving
ring (no gradient taken), which overlaps it with its kernels:
``ring_shift_start(x, axis, shift)`` returns a ``Pending`` whose
``wait()`` gives the tensor. ``x`` may itself be a ``Pending`` of the
same comm (a shard received and sent on at once): the new shift then
waits only for that one. On CUDA, ``DistComm`` issues it from a
communication stream of its own, over a group of its own, which waits
only for ``x`` (an event recorded on the caller's stream at the call, or
the ``Pending``'s own), never for the caller's later work; ``wait()``
makes the caller's current stream wait for the result. This is the
overlap that XLA's async collectives give the JAX ring
(``moviigen_tpu/parallel/ring.py:12-13``). Every other collective, the
synchronous shift too, is issued on the caller's stream over the axis'
own group.

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
code is SPMD, as the JAX package's ``shard_map`` bodies are); in the
backward too, which autograd gives when every rank's graph is the same.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...]]
AXES = ("data", "ring", "seq")
# The most CTAs (SMs) NCCL's kernels take for the asynchronous shift over
# NCCL (its groups' ``ncclConfig_t.maxCTAs``): a kernel that holds every
# SM until it ends (the ring's persistent carried forward) leaves this many
# free while a shift is in flight (``ring.RING_SPARE_SMS``). 8 is what
# NCCL picks on its own for a ring shift at r1's shards over 4 H100s; at
# S7's (1.34 GB) it picks 32, which a full grid keeps out until it ends,
# and 32 spare SMs cost the kernel a quarter of its rate. On 8 CTAs that
# shift takes about 9 ms and runs under the kernel at 8 spare SMs
# (tools/ring_overlap_probe.py).
COMM_CTAS = 8
# The axes the ring shifts over (``seq`` in ring mode, ``ring`` in USP):
# the only ones with a group for the asynchronous shift
ASYNC_AXES = (("ring",), ("seq",))


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


class Pending:
    """A shift in flight. ``wait()`` gives its result: it waits for the
    host side of the op (gloo's ``Work``s) and, where ``event`` is set
    (the op's end on a communication stream, NCCL on the card), makes the
    caller's current CUDA stream wait for it and marks the result as used
    there, so the caching allocator keeps its memory until that stream is
    done with it. A ``Pending`` made from a finished tensor
    (``ThreadComm``) returns it."""

    def __init__(self, tensor: torch.Tensor, works=(), event=None):
        self.tensor, self.event = tensor, event
        self._works = list(works)

    def wait(self) -> torch.Tensor:
        for work in self._works:
            work.wait()
        self._works = []
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


def ready(x):
    """A tensor, or a ``Pending``'s result, waited for."""
    return x.wait() if isinstance(x, Pending) else x


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
    # Subclasses implement the raw ops (``_all_to_all``, ``_ring_shift``,
    # ``_all_gather``, ``_reduce_scatter``, ``_all_reduce``), which record
    # nothing for autograd; the public ones below wrap them in
    # ``torch.autograd.Function``s.

    def all_to_all(self, x: torch.Tensor, axis: Axis, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        return self._apply(
            x, axis,
            lambda t: self._all_to_all(t, axis, split_dim, concat_dim),
            lambda g: self._all_to_all(g, axis, concat_dim, split_dim))

    def ring_shift(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        return self._apply(x, axis, lambda t: self._ring_shift(t, axis, 1),
                           lambda g: self._ring_shift(g, axis, -1))

    def all_gather(self, x: torch.Tensor, axis: Axis,
                   dim: int) -> torch.Tensor:
        return self._apply(x, axis, lambda t: self._all_gather(t, axis, dim),
                           lambda g: self._reduce_scatter(g, axis, dim))

    def reduce_scatter(self, x: torch.Tensor, axis: Axis,
                       dim: int) -> torch.Tensor:
        return self._apply(x, axis,
                           lambda t: self._reduce_scatter(t, axis, dim),
                           lambda g: self._all_gather(g, axis, dim))

    def all_reduce(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        return self._apply(x, axis, lambda t: self._all_reduce(t, axis),
                           lambda g: self._all_reduce(g, axis))

    def shard(self, x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
        n = self.axis_size(axis)
        if n > 1 and x.shape[dim] % n:
            raise ValueError(f"shard: dim {dim} of {tuple(x.shape)} does "
                             f"not split over {n} ranks")
        return self._apply(x, axis, lambda t: self._chunk(t, axis, dim),
                           lambda g: self._all_gather(g, axis, dim))

    def unshard(self, x: torch.Tensor, axis: Axis,
                dim: int) -> torch.Tensor:
        return self._apply(x, axis, lambda t: self._all_gather(t, axis, dim),
                           lambda g: self._chunk(g, axis, dim))

    def replicate(self, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        if not torch.is_grad_enabled():
            return x
        return self._apply(x, axis, lambda t: t.view_as(t),
                           lambda g: self._all_reduce(g, axis))

    def _apply(self, x, axis, fwd, bwd):
        """``fwd(x)`` with ``bwd`` as its backward; the identity over an
        axis of size 1."""
        if self.axis_size(axis) == 1:
            return x
        return _Collective.apply(x, fwd, bwd)

    def _chunk(self, x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
        """This rank's chunk of x along ``dim`` (a contiguous copy)."""
        c = x.shape[dim] // self.axis_size(axis)
        return x.narrow(dim, self.axis_index(axis) * c, c).contiguous()

    def _all_to_all(self, x, axis, split_dim, concat_dim):
        raise NotImplementedError

    def ring_shift_start(self, x, axis: Axis, shift: int = 1) -> Pending:
        """Start ``_ring_shift``: x (a tensor, or a ``Pending`` of this
        comm) to the rank ``shift`` places on along the axis (1: the
        next, -1: the previous); the ``Pending`` gives that rank's
        counterpart. Records nothing for autograd."""
        raise NotImplementedError

    def _ring_shift(self, x, axis, shift=1):
        """x to the rank ``shift`` places on along the axis (1: the next,
        -1: the previous); that rank's counterpart comes back."""
        raise NotImplementedError

    def _all_gather(self, x, axis, dim):
        raise NotImplementedError

    def _reduce_scatter(self, x, axis, dim):
        raise NotImplementedError

    def _all_reduce(self, x, axis):
        raise NotImplementedError


class _Collective(torch.autograd.Function):
    """``fwd(x)`` recorded for autograd with ``bwd(grad)`` as its
    backward; both are raw collectives (or local ops), which record
    nothing."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous()), None, None


class DistComm(Comm):
    """A ``Comm`` over ``torch.distributed``: one process per rank.
    ``ranks[p]`` is the global rank at mesh position p; ``groups`` maps
    each axis key (a tuple of names) to this rank's sub-group,
    ``async_groups`` each key of ``ASYNC_AXES`` to a second one for the
    asynchronous shift (``build``). Build it with
    ``parallel.mesh.make_mesh``: every process of the world must take
    part in creating the sub-groups."""

    def __init__(self, data: int, ring: int, seq: int, rank: int,
                 ranks: Sequence[int], groups, async_groups):
        super().__init__(data, ring, seq, rank)
        self.ranks = list(ranks)
        self.groups = groups
        self.async_groups = async_groups
        self._streams = {}  # device index → the communication stream

    @classmethod
    def build(cls, data: int, ring: int, seq: int,
              ranks: Sequence[int]) -> Optional["DistComm"]:
        """Create every sub-group of a ``(data, ring, seq)`` mesh laid
        over the global ``ranks`` (a collective call of the whole world)
        and return this process' comm, or None where it is not in the
        mesh. The axes of ``ASYNC_AXES`` get a second group for the
        asynchronous shift, so that a shift in flight never holds up a
        collective on the caller's stream behind it (a group's NCCL work
        runs on one stream, in the order it was issued). Over NCCL that
        group runs on a high-priority stream and takes at most
        ``COMM_CTAS`` CTAs."""
        import torch.distributed as dist

        me = dist.get_rank()
        probe = Comm(data, ring, seq, 0)
        groups, async_groups = {}, {}
        opts = None
        if dist.get_backend() == "nccl":
            # its kernels come first where SMs free up, and stay within
            # COMM_CTAS SMs
            opts = dist.ProcessGroupNCCL.Options(is_high_priority_stream=True)
            opts.config.max_ctas = COMM_CTAS
        # a group for every set of axes, named in mesh order
        keys = [key for n in range(1, len(AXES) + 1)
                for key in itertools.combinations(AXES, n)]
        for key in keys:
            others = [a for a in AXES if a not in key]
            for combo in itertools.product(*(range(probe.sizes[a])
                                              for a in others)):
                coords = dict.fromkeys(AXES, 0)
                coords.update(zip(others, combo))
                members = [ranks[p] for p in probe.positions(key, coords)]
                group = dist.new_group(members)
                if me in members:
                    groups[key] = group
                if key in ASYNC_AXES:
                    group = dist.new_group(members, pg_options=opts)
                    if me in members:
                        async_groups[key] = group
        if me not in ranks:
            return None
        return cls(data, ring, seq, list(ranks).index(me), ranks, groups,
                   async_groups)

    def _key(self, axis: Axis):
        axes = self._axes(axis)
        return tuple(a for a in AXES if a in axes)

    def _group(self, axis: Axis):
        return self.groups[self._key(axis)]

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        """This device's communication stream (high priority, as the
        async groups' NCCL streams)."""
        stream = self._streams.get(device.index)
        if stream is None:
            stream = self._streams[device.index] = torch.cuda.Stream(
                device, priority=-1)
        return stream

    def ring_shift_start(self, x, axis, shift=1):
        """``Comm.ring_shift_start`` over the axis' async group. Gloo: the
        ``Work``s are waited on in ``Pending.wait``. CUDA: the shift runs
        on this device's communication stream, which first waits for x
        alone (x's ``Pending``'s event, or an event recorded now on the
        caller's stream), then for the op (``Work.wait``), and records the
        ``Pending``'s event. The output is allocated on that stream, and x
        is marked as used there, so the caching allocator reuses neither
        before the stream is done with them. Raises where the axis has no
        async group or the stream cannot be had: there is no synchronous
        fallback."""
        import torch.distributed as dist

        key = self._key(axis)
        if key not in self.async_groups:
            raise ValueError(f"no asynchronous shift over {key}: the ring "
                             f"shifts over {ASYNC_AXES}")
        group = self.async_groups[key]
        members = [self.ranks[p] for p in self.group(axis)]
        n, i = len(members), self.axis_index(axis)
        event = x.event if isinstance(x, Pending) else None
        t = x.tensor if event is not None else ready(x)

        def issue():
            send = t.contiguous()
            recv = torch.empty_like(send)
            ops = [dist.P2POp(dist.isend, send, members[(i + shift) % n],
                              group),
                   dist.P2POp(dist.irecv, recv, members[(i - shift) % n],
                              group)]
            return recv, dist.batch_isend_irecv(ops)

        if not t.is_cuda:
            return Pending(*issue())
        if event is None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
        stream = self._stream(t.device)
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            t.record_stream(stream)
            recv, works = issue()
            for work in works:
                work.wait()  # this stream waits for NCCL's
        done = torch.cuda.Event()
        done.record(stream)
        return Pending(recv, event=done)

    def _all_to_all(self, x, axis, split_dim, concat_dim):
        import torch.distributed as dist

        n = self.axis_size(axis)
        send = _split_to_front(x, n, split_dim)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._group(axis))
        return _merge_from_front(recv, concat_dim)

    def _ring_shift(self, x, axis, shift=1):
        import torch.distributed as dist

        members = [self.ranks[p] for p in self.group(axis)]
        n, i = len(members), self.axis_index(axis)
        send = x.contiguous()
        recv = torch.empty_like(send)
        group = self._group(axis)
        ops = [dist.P2POp(dist.isend, send, members[(i + shift) % n], group),
               dist.P2POp(dist.irecv, recv, members[(i - shift) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def _all_gather(self, x, axis, dim):
        import torch.distributed as dist

        n = self.axis_size(axis)
        send = x.movedim(dim, 0).contiguous()
        recv = send.new_empty((n * send.shape[0], *send.shape[1:]))
        dist.all_gather_into_tensor(recv, send, group=self._group(axis))
        return recv.movedim(0, dim).contiguous()

    def _reduce_scatter(self, x, axis, dim):
        import torch.distributed as dist

        n = self.axis_size(axis)
        send = x.movedim(dim, 0).contiguous()
        if send.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(x.shape)} does not split over {n} "
                             "ranks")
        recv = send.new_empty((send.shape[0] // n, *send.shape[1:]))
        # reduce_scatter_tensor is the older name of reduce_scatter_single
        fn = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        fn(recv, send, group=self._group(axis))
        return recv.movedim(0, dim).contiguous()

    def _all_reduce(self, x, axis):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=self._group(axis))
        return out


class _Rendezvous:
    """What the threads of one ``ThreadComm`` mesh share: a barrier and
    one slot per rank."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: List[Optional[torch.Tensor]] = [None] * n

    def exchange(self, rank: int, x: torch.Tensor,
                 build: Callable[[List[torch.Tensor]], torch.Tensor]
                 ) -> torch.Tensor:
        """``build(every rank's x)``, once all ranks have put theirs in.
        ``build`` reads the peers' tensors between the two barriers: no
        rank goes on before every rank has read, so a rank that writes
        into its own tensor after the collective (an accumulator added to
        in place) never races a peer's read of it."""
        self.slots[rank] = x
        self.barrier.wait()
        out = build(list(self.slots))
        self.barrier.wait()  # all have read before any writes again
        return out


class ThreadComm(Comm):
    """A ``Comm`` whose ranks are threads of one process (``thread_mesh``,
    ``run_ranks``). A collective puts each rank's tensor in a shared slot
    table, waits at a barrier for the others, builds its result from the
    slots with ordinary tensor ops (concatenation, slicing, a copy, a sum
    in rank order), and waits at a second barrier before it returns, so
    every read of a peer's tensor is done before that peer goes on. The
    asynchronous shift (``ring_shift_start``) does the exchange at once
    and returns it finished. The raw ops run inside the
    autograd functions' forward and backward, where nothing is recorded:
    a rank's graph never reaches into a peer's tensors, so each rank's
    backward runs only its own graph.

    On the card every thread launches on the same stream, the one that
    was current where ``run_ranks`` was called: the order in which the
    threads pass the barrier on the host is then also the order of their
    work on the device, so a rank that reads a peer's tensor after the
    barrier reads it finished, with no event between them. A second
    stream would break that, so ``ThreadComm`` has none."""

    def __init__(self, data: int, ring: int, seq: int, rank: int,
                 rendezvous: _Rendezvous):
        super().__init__(data, ring, seq, rank)
        self._rv = rendezvous

    def _exchange(self, x: torch.Tensor, axis: Axis,
                  build: Callable[[List[torch.Tensor]], torch.Tensor]
                  ) -> torch.Tensor:
        """``build`` over the axis' tensors in ``axis_index`` order."""
        group = self.group(axis)
        return self._rv.exchange(
            self.rank, x, lambda slots: build([slots[p] for p in group]))

    def _all_to_all(self, x, axis, split_dim, concat_dim):
        n, i = self.axis_size(axis), self.axis_index(axis)
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of "
                             f"{tuple(x.shape)} does not split into {n} "
                             "chunks")
        c = x.shape[split_dim] // n
        return self._exchange(x, axis, lambda peers: torch.cat(
            [p.narrow(split_dim, i * c, c) for p in peers],
            dim=concat_dim).contiguous())

    def _ring_shift(self, x, axis, shift=1):
        n, i = self.axis_size(axis), self.axis_index(axis)
        return self._exchange(x, axis,
                              lambda peers: peers[(i - shift) % n].clone())

    def ring_shift_start(self, x, axis, shift=1):
        return Pending(self._ring_shift(ready(x), axis, shift))

    def _all_gather(self, x, axis, dim):
        return self._exchange(
            x, axis, lambda peers: torch.cat(peers, dim=dim).contiguous())

    def _reduce_scatter(self, x, axis, dim):
        n, i = self.axis_size(axis), self.axis_index(axis)
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(x.shape)} does not split over {n} "
                             "ranks")
        c = x.shape[dim] // n
        return self._exchange(x, axis, lambda peers: _sum(
            [p.narrow(dim, i * c, c) for p in peers]).contiguous())

    def _all_reduce(self, x, axis):
        return self._exchange(x, axis, _sum)


def _sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """x₀ + x₁ + … added in rank order, so that every rank gets the same
    bits."""
    out = xs[0].clone()
    for x in xs[1:]:
        out += x
    return out


def thread_mesh(data: int = 1, seq: int = 1, ring: int = 1,
                timeout: float = 600.0) -> List[ThreadComm]:
    """A ``(data, ring, seq)`` mesh of thread ranks: one ``ThreadComm``
    per mesh position, in rank order. Drive it with ``run_ranks``."""
    n = data * ring * seq
    rv = _Rendezvous(n, timeout)
    return [ThreadComm(data, ring, seq, r, rv) for r in range(n)]


def own_trained(module):
    """``module``, a thread rank's copy from ``sharding.shard_params``,
    with its own copy of each trained tensor that is not a shard, in
    place. ``shard_params`` shares those with every other rank's copy;
    a rank that trains needs its own, so that the in-place optimizer
    update runs once on each. Frozen tensors stay shared. Returns
    ``module``."""
    from torch import nn

    from .sharding import is_shard

    for m in module.modules():
        for name, p in m._parameters.items():
            if p is not None and p.requires_grad and not is_shard(p):
                m._parameters[name] = nn.Parameter(p.detach().clone())
    return module


def run_ranks(fn: Callable[[ThreadComm], object],
              comms: Sequence[ThreadComm]) -> list:
    """``fn(comm)`` for every rank of a ``thread_mesh``, each in a thread
    of its own; returns the results in rank order. The threads take the
    caller's grad mode, CUDA device and current stream (each is per
    thread in PyTorch), so the ranks run after the work that made their
    inputs, on one stream. Each runs its backward passes on its own thread
    (``torch.autograd.set_multithreading_enabled(False)``, thread-local):
    PyTorch otherwise runs the CUDA nodes of every backward in the
    process on one worker thread per device, where rank 0's first
    backward collective would wait at the barrier for rank 1's, queued
    behind it.
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
            with torch.set_grad_enabled(grad), torch.cuda.stream(stream), \
                    torch.autograd.set_multithreading_enabled(False):
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
