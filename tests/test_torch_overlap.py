"""The overlap of the port's collectives with its kernels
(``moviigen_tpu_torch/parallel``): the asynchronous shift
(``Comm.ring_shift_start``) against its synchronous form on thread
ranks and over gloo, the SMs the ring's kernel leaves to it, the ring's
schedule (serving: each shift started before the kernels it must not
wait for, each shard waited for where it is first used; training:
synchronous shifts), the serving ring's output and the overlapped
training candidate (``tools/ring_overlap_probe.py``) bit-equal to the
training ring's, thread ranks that write into their tensors right after
a collective, and the profile's split of device time
(``utils/profiling.comm_overlap``, ``tools/cards.py``).

This file imports neither JAX nor the JAX package: the ring is held to
JAX in ``test_torch_parallel.py`` and ``test_torch_sp_training.py``,
which pass through the same code."""

import sys

import pytest
import torch
import torch.distributed as dist

from moviigen_tpu_torch.parallel import ring
from moviigen_tpu_torch.parallel.comm import (Comm, Pending, run_ranks,
                                              thread_mesh)
from moviigen_tpu_torch.parallel.mesh import make_mesh
from moviigen_tpu_torch.utils.profiling import comm_overlap
from test_torch_parallel_dist import _free_port, _spawn
from tools import cards
from tools.ring_overlap_probe import OverlappedRing

_CARRY, _BWD = ring.flash_attention_carry, ring.flash_bwd_plain


def _rank_tensor(rank, shape=(2, 3, 4)):
    return torch.arange(24, dtype=torch.float32).reshape(shape) + 100 * rank


def _check_async_forms(comm):
    """On ``comm``'s 'seq' axis: the started shift's ``wait()`` is the
    synchronous shift and the peer's tensor; a shift started on a
    ``Pending`` passes the received tensor on; the synchronous gather is
    the concatenation in rank order."""
    n, i = comm.axis_size("seq"), comm.axis_index("seq")
    x = _rank_tensor(i)
    for shift in (1, -1):
        got = comm.ring_shift_start(x, "seq", shift).wait()
        assert torch.equal(got, _rank_tensor((i - shift) % n))
        assert torch.equal(comm._ring_shift(x, "seq", shift), got)
    first = comm.ring_shift_start(x, "seq", -1)
    second = comm.ring_shift_start(first, "seq", -1)
    assert torch.equal(second.wait(), _rank_tensor((i + 2) % n))
    assert torch.equal(first.wait(), _rank_tensor((i + 1) % n))
    for dim in (0, 1):
        got = comm._all_gather(x, "seq", dim)
        want = torch.cat([_rank_tensor(r) for r in range(n)], dim=dim)
        assert torch.equal(got, want) and got.is_contiguous()
    return True


def _ring_results(fn, comm, sp, me, k_lens=None):
    """out, dq, dk, dv of one ring forward and backward (``fn``: an
    autograd function of ``RingAttention``'s signature) over rank
    ``me``'s shards of a 4 × 128-key sequence (bf16, the plain twins), a
    fixed output gradient; and the forward's out with no gradient taken
    (serving)."""
    gen = torch.Generator().manual_seed(me)
    q, k, v, g = (torch.randn(1, 128 * 4 // sp, 2, 32, generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    args = (k_lens, comm, "seq", 32 ** -0.5, "auto")
    with torch.no_grad():
        served = fn.apply(q, k, v, *args)
    x = [t.requires_grad_(True) for t in (q, k, v)]
    out = fn.apply(*x, *args)
    out.backward(g)
    return [out.detach()] + [t.grad for t in x] + [served]


def _ring_bit_equal(comm):
    """On ``comm``'s 'seq' axis the training ring's out, dq, dk, dv and
    the serving ring's out (its shifts overlapped) are the overlapped
    training candidate's (``ring_overlap_probe.OverlappedRing``) bit for
    bit, and the serving out is the training out: with every key valid,
    and with keys past 300 masked (the last 128-key shard empty)."""
    sp, me = comm.axis_size("seq"), comm.axis_index("seq")
    for k_lens in (None, torch.tensor([300], dtype=torch.int32)):
        got = _ring_results(OverlappedRing, comm, sp, me, k_lens)
        want = _ring_results(ring.RingAttention, comm, sp, me, k_lens)
        for a, b in zip(got, want + [want[0]]):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    return True


def test_async_shift_equals_sync_on_thread_ranks():
    assert all(run_ranks(_check_async_forms, thread_mesh(seq=4)))


def _gloo_worker(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        comm = make_mesh(seq=world)
        _check_async_forms(comm)
        # only the ring's axes have a group for the asynchronous shift
        with pytest.raises(ValueError, match="no asynchronous shift"):
            comm.ring_shift_start(_rank_tensor(rank), ("data", "seq"))
        _ring_bit_equal(comm)
    finally:
        dist.destroy_process_group()


def test_async_shift_equals_sync_over_gloo():
    """The same checks on ``DistComm`` over gloo, 4 ranks, a shift over
    axes with no async group raises, and the ring's results are the same
    bits in every schedule (``_ring_bit_equal``; a worker's failed check
    fails the spawn)."""
    _spawn(_gloo_worker, 4, 4, _free_port())


def test_overlapped_ring_equals_synchronous_on_thread_ranks():
    """The overlapped training candidate's out, dq, dk, dv (forward and
    backward under autograd) and the serving ring's out against the
    training ring's, whose shifts are synchronous, on 4 thread ranks: the
    same bits."""
    assert all(run_ranks(_ring_bit_equal, thread_mesh(seq=4)))


def test_spare_sms_only_while_a_shift_runs_on_a_stream():
    """The ring's kernel leaves SMs free only while a shift of its block
    runs on a communication stream (a ``Pending`` with an event: NCCL on
    the card); finished shifts (thread ranks, gloo) and tensors need
    none."""
    t = torch.zeros(2)
    assert ring._spare_sms((t, t)) == 0
    assert ring._spare_sms((Pending(t), Pending(t))) == 0
    on_stream = Pending(t, event=object())
    assert ring._spare_sms((Pending(t), on_stream)) == ring.RING_SPARE_SMS
    assert ring.RING_SPARE_SMS > 0


class _Recorder(Comm):
    """Rank ``me`` of a ring of ``sp`` ranks with no peers: a shift hands
    back a copy of what it sends. It logs ("start", s) for each shift
    started and ("wait", s) where a shift's result is first waited for, s
    the key shard the result stands for (x's shard moved ``shift`` places
    on: rank me ends up with the shard of rank me - shift). A shift started
    on a ``Pending`` does not wait for it, as on the card."""

    def __init__(self, sp, me):
        super().__init__(1, 1, sp, me)
        self.log, self.shard, self._keep = [], {}, []

    def label(self, t, shard):
        self.shard[t.data_ptr()] = shard
        self._keep.append(t)
        return t

    def ring_shift_start(self, x, axis, shift=1):
        t = x.tensor if isinstance(x, Pending) else x
        got = (self.shard[t.data_ptr()] - shift) % self.sizes["seq"]
        self.log.append(("start", got))
        return _LoggedPending(self.label(t.clone(), got), self.log, got)

    def _ring_shift(self, x, axis, shift=1):
        got = (self.shard[x.data_ptr()] - shift) % self.sizes["seq"]
        self.log.append(("shift", got))
        return self.label(x.clone(), got)


class _LoggedPending(Pending):
    def __init__(self, tensor, log, shard):
        super().__init__(tensor)
        self._log, self._shard, self._waited = log, shard, False

    def wait(self):
        if not self._waited:
            self._log.append(("wait", self._shard))
            self._waited = True
        return super().wait()


def _recorded(monkeypatch, rec):
    """Log the ring's kernels, each with its key shard."""

    def carry_logged(q, k, v, *a, **kw):
        assert kw["spare_sms"] == 0  # the recorder's shifts are finished
        rec.log.append(("kernel", rec.shard[k.data_ptr()]))
        return _CARRY(q, k, v, *a, **kw)

    def bwd_logged(q, k, v, *a, **kw):
        rec.log.append(("pair", rec.shard[k.data_ptr()]))
        return _BWD(q, k, v, *a, **kw)

    monkeypatch.setattr(ring, "flash_attention_carry", carry_logged)
    monkeypatch.setattr(ring, "flash_bwd_plain", bwd_logged)


def _qkv(me, requires_grad):
    gen = torch.Generator().manual_seed(me)
    return [torch.randn(1, 128, 2, 32, generator=gen).to(torch.bfloat16)
            .requires_grad_(requires_grad) for _ in range(3)]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_starts_each_shift_before_the_kernels(monkeypatch, sp):
    """The serving ring's schedule (no gradient taken) on every rank of
    sp: step s starts the shift of what it received (K, then V) before
    its kernels, and a shard is waited for where its first kernel needs
    it."""
    for me in range(sp):
        rec = _Recorder(sp, me)
        _recorded(monkeypatch, rec)
        q, k, v = _qkv(me, False)
        for t in (k, v):
            rec.label(t, me)
        with torch.no_grad():
            ring.RingAttention.apply(q, k, v, None, rec, "seq", 32 ** -0.5,
                                     "auto")
        want = []
        for s, todo in enumerate(ring.natural_order(sp, me)):
            if s < sp - 1:
                want += [("start", (me + s + 1) % sp)] * 2
            for j in todo:
                want += [("wait", j)] * 2 * (j != me) + [("kernel", j)]
        assert rec.log == want, (me, rec.log)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_shifts_synchronously_under_autograd(monkeypatch, sp):
    """Under a training step (q, k, v need gradients) the ring starts no
    shift: the forward shifts what it received (K, then V) before its
    step's kernels, and the backward runs each pair, then shifts the
    accumulators (dK, then dV) with their shard and, but for the last
    step, K and V to the next pair."""
    for me in range(sp):
        rec = _Recorder(sp, me)
        _recorded(monkeypatch, rec)
        q, k, v = _qkv(me, True)
        for t in (k, v):
            rec.label(t, me)
        out = ring.RingAttention.apply(q, k, v, None, rec, "seq", 32 ** -0.5,
                                       "auto")
        want = []
        for s, todo in enumerate(ring.natural_order(sp, me)):
            if s < sp - 1:
                want += [("shift", (me + s + 1) % sp)] * 2
            want += [("kernel", j) for j in todo]
        assert rec.log == want, (me, rec.log)
        rec.log.clear()
        # the accumulators start as zeros labelled with the rank's shard
        zeros = torch.zeros
        monkeypatch.setattr(torch, "zeros", lambda *a, **kw: rec.label(
            zeros(*a, **kw), me))
        out.float().sum().backward()
        monkeypatch.setattr(torch, "zeros", zeros)
        want = []
        for s in range(sp):
            held, nxt = (me - s) % sp, (me - s - 1) % sp
            want += [("pair", held)] + [("shift", nxt)] * (
                2 + 2 * (s < sp - 1))
        assert rec.log == want, (me, rec.log)
        assert q.grad is not None and k.grad.shape == k.shape


def test_thread_exchange_reads_before_a_peer_writes():
    """Thread ranks that write into their own tensor in place right after
    each collective (an accumulator added to, a buffer filled again),
    many rounds, the interpreter switching threads every microsecond:
    every rank reads each peer's tensor as it was put in."""
    n, rounds = 4, 150

    def rank(comm):
        x = torch.zeros(4096)
        for i in range(rounds):
            x.fill_(comm.rank * 1000 + i)
            gathered = comm._all_gather(x, "seq", 0).view(n, -1)
            shifted = comm._ring_shift(x, "seq", 1)
            x.add_(0.5)
            for r in range(n):
                assert bool((gathered[r] == r * 1000 + i).all())
            assert bool((shifted == (comm.rank - 1) % n * 1000 + i).all())
        return True

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert all(run_ranks(rank, thread_mesh(seq=n, timeout=60)))
    finally:
        sys.setswitchinterval(interval)


def test_comm_overlap_splits_nccl_time():
    """``comm_overlap`` on a made-up trace (ns): two compute kernels
    [0, 10) and [20, 30), NCCL kernels [5, 15) and [25, 40), a copy
    [12, 13) in a window of [0, 50): compute 21, NCCL 25, 10 of it under
    compute (with the copy), 11 of NCCL's under compute, 14 exposed; the
    device is busy 35 of 50."""
    ms = 1_000_000  # 1 ms in ns
    iv = [("gemm", 0, 10 * ms), ("ncclDevKernel_SendRecv(x)", 5 * ms,
                                  15 * ms),
          ("Memcpy DtoD", 12 * ms, 13 * ms), ("flash", 20 * ms, 30 * ms),
          ("ncclDevKernel_SendRecv(x)", 25 * ms, 40 * ms)]
    s = comm_overlap(iv, (0, 50 * ms))
    assert s["compute_ms"] == 21 and s["nccl_ms"] == 25
    assert s["nccl_under_compute_ms"] == 11
    assert s["exposed_nccl_ms"] == 14
    assert s["idle_share"] == pytest.approx(1 - 35 / 50)
    assert s["nccl_by_kernel"] == {"ncclDevKernel_SendRecv": (2, 25.0, 14.0)}


def _chrome(path, kernels, base=1_000_000_000):
    """A Chrome trace of device kernels (name, start ms, end ms, stream,
    grid), times relative to ``base`` ns as the profiler writes them."""
    import json

    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": t0 * 1000.0,
               "dur": (t1 - t0) * 1000.0,
               "args": {"stream": st, "grid": grid}}
              for n, t0, t1, st, grid in kernels]
    path.write_text(json.dumps({"baseTimeNanoseconds": base,
                                "traceEvents": events}))
    return path


def test_nccl_ops_lined_up_across_ranks(tmp_path):
    """``cards.nccl_ops`` reads a rank's NCCL kernels by group (the
    stream ``comm_streams`` named) and op, with the compute kernel before
    each; ``nccl_by_group`` sums them; ``nccl_waits`` lines the k-th op
    of a group up across its ranks: rank 0's all-reduce waits 1.5 ms for
    rank 1, which arrives last after its GEMM; the shifts' group, with
    rank 0 last, waits 2 ms on rank 1. Two processes write times from
    bases of their own, on one clock."""
    ar = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)"
    sr = "ncclDevKernel_SendRecv(ncclDevKernelArgs)"
    g1, g8 = [16, 1, 1], [8, 1, 1]
    rank0 = _chrome(tmp_path / "r0.json", [
        ("flash", 0.0, 9.0, 7, g1), (ar, 10.0, 12.0, 13, g1),
        (sr, 20.0, 21.0, 21, g8)])
    rank1 = _chrome(tmp_path / "r1.json", [
        ("gemm", 6.0, 12.4, 7, g1), (ar, 12.5, 13.0, 13, g1),
        (sr, 19.0, 22.0, 21, g8)], base=1_000_000_000 - 1_000_000)
    streams = {"13": "sync:seq", "21": "shift:seq"}
    ops = [cards.nccl_ops(p, streams) for p in (rank0, rank1)]
    assert [op[:2] for op in ops[0]] == [["sync:seq", "all-reduce"],
                                         ["shift:seq", "send/receive"]]
    assert ops[1][0][6] == "gemm" and ops[0][0][6] == "flash"
    by = cards.nccl_by_group(ops[0])
    assert by == {"sync:seq all-reduce": [1, 2.0, 2.0, 16],
                  "shift:seq send/receive": [1, 1.0, 1.0, 8]}
    # rank 1 writes its times from a base 1 ms earlier
    members = [{"sync:seq": [0, 1], "shift:seq": [0, 1]}] * 2
    waits = cards.nccl_waits(ops, members)
    ar_w = waits["sync:seq all-reduce"]
    assert ar_w["ops"] == 1 and ar_w["last"] == [0, 1]
    assert ar_w["wait_ms"] == [1.5, 0.0]
    assert ar_w["last_rank_ran_before"] == [["gemm", 1.5]]
    sr_w = waits["shift:seq send/receive"]
    assert sr_w["last"] == [1, 0] and sr_w["wait_ms"] == [0.0, 2.0]
    assert sr_w["after_ms"] == [1.0, 1.0]
    assert sr_w["last_rank_ran_before"] == [["flash", 2.0]]


def test_profile_traces_the_second_step(tmp_path):
    """``tools/sp_serve_cards.py --profile``: the step list a request
    fills opens the trace once step 0 is timed and closes it once step 1
    is, so one step is traced and no step pays for opening or closing it;
    ``cards.profile_summary`` reduces the trace (on the CPU: no device
    activity, so no NCCL time and an idle device)."""
    from tools import cards, sp_serve_cards

    done = []
    steps = sp_serve_cards._TracedSteps(tmp_path / "trace", "cpu", done)
    for i in range(4):
        torch.ones(64).add_(i)
        steps.append(0.5 * i)
    assert steps == [0.0, 0.5, 1.0, 1.5] and len(done) == 1
    tr = done[0]
    assert tr.path is not None and tr.window_ns[1] > tr.window_ns[0]
    summary = cards.profile_summary(tr, blocks=2)
    assert summary["nccl_ms"] == 0
    assert summary["exposed_nccl_ms_per_block"] == 0
    assert summary["idle_share"] == 1.0 and summary["blocks"] == 2
