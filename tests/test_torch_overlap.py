"""The overlap of the port's collectives with its kernels
(``moviigen_tpu_torch/parallel``): the asynchronous shift
(``Comm.ring_shift_start``) against its synchronous form on thread
ranks and over gloo, the SMs the ring's kernel leaves to it, the ring's
schedule (serving: each shift started before the kernels it must not
wait for, each shard waited for where it is first used; training:
synchronous shifts), thread ranks that write into their tensors right
after a collective, and the profile's split of device time
(``utils/profiling.comm_overlap``).

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
    finally:
        dist.destroy_process_group()


def test_async_shift_equals_sync_over_gloo():
    """The same checks on ``DistComm`` over gloo, 4 ranks, and a shift
    over axes with no async group raises (a worker's failed check fails
    the spawn)."""
    _spawn(_gloo_worker, 4, 4, _free_port())


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
