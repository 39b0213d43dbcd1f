"""The port's sequence parallelism (``moviigen_tpu_torch/parallel``)
against the JAX package's on its virtual CPU mesh (``tests/conftest.py``),
at t2v-tiny in fp32.

The port's ranks are threads (``ThreadComm``); ``test_torch_parallel_dist``
holds ``DistComm`` over gloo to the same results. Both DiTs carry the
same weights (the JAX random init with a live head, through ``convert``),
and the JAX side runs its plain attention (``attn_backend="xla"``) where
the port runs its kernels' plain twins on the CPU. The two agree within
1e-5 of the output's scale: the same fp32 arithmetic summed in other
orders (the twins' base-2 softmax over 512-key blocks against one
softmax), a few ulps of each logit; a scrambled head, token shard or
padding row is off by O(1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.ops.rope import rope_3d_freqs as jax_rope
from moviigen_tpu.parallel import ring as jring
from moviigen_tpu.parallel.mesh import make_mesh as jax_make_mesh
from moviigen_tpu.parallel.mesh import make_pod_mesh as jax_make_pod_mesh
from moviigen_tpu.parallel.ulysses import \
    sequence_parallel_forward as jax_sp_forward
from moviigen_tpu_torch import convert
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops import flash_attention as tfa
from moviigen_tpu_torch.ops.flash_attention import LOG2E
from moviigen_tpu_torch.ops.rope import rope_3d_freqs
from moviigen_tpu_torch.parallel import ring, sharding
from moviigen_tpu_torch.parallel.comm import run_ranks, thread_mesh
from moviigen_tpu_torch.parallel.mesh import make_mesh, make_pod_mesh
from moviigen_tpu_torch.parallel import ulysses
from moviigen_tpu_torch.parallel.ulysses import (sequence_parallel_forward,
                                                 sp_seq_len)

CFG = WAN_CONFIGS["t2v-tiny"].model
JCFG = JAX_CONFIGS["t2v-tiny"].model
REL_TOL = 1e-5
GRID = (4, 4, 4)  # 64 tokens


@pytest.fixture(scope="module")
def setup():
    params = jwan.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    head = params["head"]["head"]
    head["kernel"] = jnp.asarray(np.random.default_rng(1).standard_normal(
        head["kernel"].shape) * 0.1, jnp.float32)
    model = convert.load_wan_params(
        WanModel(CFG, dtype=torch.float32, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, CFG.in_dim, 4, 8, 8)).astype(np.float32)
    t = np.asarray([500.0, 250.0], np.float32)
    ctx = rng.standard_normal((2, CFG.text_len, CFG.text_dim)) \
        .astype(np.float32)
    return params, model, x, t, ctx


def _port(model, x, t, ctx, mesh, **kw):
    """The port's SP forward on every thread rank of ``mesh``
    ((data, ring, seq)); asserts that the ranks agree, returns rank 0's."""
    rope = rope_3d_freqs(GRID, CFG.head_dim)
    args = [torch.from_numpy(a) for a in (x, t, ctx)]
    fsdp = kw.pop("fsdp", False)

    def rank(comm):
        m = model
        if fsdp:
            m = sharding.shard_params(model, sharding.dit_param_specs(model),
                                      comm, sharding.shard_axis(comm))
        return sequence_parallel_forward(m, *args, rope, comm,
                                         compute_dtype=torch.float32,
                                         fsdp_params=fsdp, **kw)

    data, ring_n, seq = mesh
    with torch.no_grad():
        outs = run_ranks(rank, thread_mesh(data=data, ring=ring_n, seq=seq))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0].numpy()


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 0.1  # the live head shapes the output
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("sp_mode,mesh,seq_len,fsdp", [
    ("ulysses", (1, 1, 2), None, False),
    ("ulysses", (2, 1, 2), None, True),
    ("ring", (1, 1, 2), 72, False),       # 64 tokens padded to 72
    ("usp", (1, 2, 2), None, False),
    ("usp", (2, 2, 2), 72, True),
])
def test_sp_forward_matches_jax(setup, sp_mode, mesh, seq_len, fsdp):
    """The port's SP forward over thread ranks against JAX's
    ``sequence_parallel_forward`` on the same (data, ring, seq) mesh; the
    port's with ``fsdp`` holds its block weights as shards gathered per
    block (the same bytes, so the same result)."""
    params, model, x, t, ctx = setup
    data, ring_n, seq = mesh
    jmesh = jax_make_mesh(data=data, ring=ring_n, seq=seq)
    rope = jax_rope(GRID, JCFG.head_dim)
    want = np.asarray(jax.jit(lambda p, x, t, c: jax_sp_forward(
        p, x, t, c, JCFG, rope, jmesh, seq_len=seq_len,
        compute_dtype=jnp.float32, attn_backend="xla", sp_mode=sp_mode))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    got = _port(model, x, t, ctx, mesh, seq_len=seq_len, sp_mode=sp_mode,
                fsdp=fsdp)
    _close(got, want)


def test_sp_forward_equals_one_process(setup):
    """Ulysses over 2 ranks is the one-process forward, bit for bit, on
    the CPU: each head's attention is the same computation, split over
    ranks."""
    _, model, x, t, ctx = setup
    with torch.no_grad():
        want = model(*(torch.from_numpy(a) for a in (x, t, ctx)),
                     rope_3d_freqs(GRID, CFG.head_dim),
                     compute_dtype=torch.float32).numpy()
    got = _port(model, x, t, ctx, (1, 1, 2), sp_mode="ulysses")
    assert np.array_equal(got, want)


def test_all_to_all_matches_jax():
    """``Comm.all_to_all`` is ``jax.lax.all_to_all(tiled=True)``: heads
    scatter, tokens gather in rank order (and back), with heads that
    differ, over 4 ranks."""
    x = np.random.default_rng(2).standard_normal((2, 8, 4, 3)) \
        .astype(np.float32)  # [B, L, N, D], tokens sharded over 'seq'
    jmesh = jax_make_mesh(data=1, seq=4)

    def jfwd(a):
        return jax.lax.all_to_all(a, "seq", 2, 1, tiled=True)

    want = np.asarray(shard_map(jfwd, mesh=jmesh, in_specs=P(None, "seq"),
                                out_specs=P(None, None, "seq"),
                                check_rep=False)(jnp.asarray(x)))
    xs = torch.from_numpy(x).chunk(4, dim=1)
    comms = thread_mesh(seq=4)
    outs = run_ranks(lambda c: c.all_to_all(xs[c.rank], "seq", 2, 1), comms)
    assert np.array_equal(torch.cat(outs, dim=2).numpy(), want)
    back = run_ranks(lambda c: c.all_to_all(outs[c.rank], "seq", 1, 2),
                     comms)
    assert np.array_equal(torch.cat(back, dim=1).numpy(), x)


def test_mesh_layout_matches_jax():
    """A rank's mesh position and axis indices are those of the JAX
    device at the same place of ``make_mesh``'s (data, ring, seq) grid."""
    jmesh = jax_make_mesh(data=2, ring=2, seq=2)
    for comm in thread_mesh(data=2, ring=2, seq=2):
        c = comm.coords
        assert jmesh.devices[c["data"], c["ring"], c["seq"]].id \
            == comm.rank
        assert comm.axis_index(("ring", "seq")) == 2 * c["ring"] + c["seq"]
    assert thread_mesh(data=2, seq=4)[0].shape == dict(
        jax_make_mesh(data=2, seq=4).shape)


def test_local_klens_matches_jax():
    k_lens = np.asarray([72, 64, 10, 0], np.int32)
    for src in range(4):
        want = np.asarray(jring._local_klens(jnp.asarray(k_lens), src, 18))
        got = ring._local_klens(torch.from_numpy(k_lens), src, 18)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    assert ring._local_klens(None, 1, 18) is None


def test_ring_with_an_empty_shard_matches_jax():
    """Ring attention over 4 thread ranks with batch entry 1's keys ending
    at 27 of 48: its last key shard (36-47) is empty and the third holds 3
    keys; the empty shard's partial (m = -1e30, l = 0) must add nothing.
    Against JAX's ring on its mesh."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
               for _ in range(3))
    k_lens = np.asarray([48, 27], np.int32)
    jmesh = jax_make_mesh(data=1, seq=4)

    def jfn(q, k, v, kl):
        return jring.ring_self_attention(q, k, v, kl, axis_name="seq",
                                         sp_size=4, attn_backend="xla",
                                         compute_dtype=jnp.float32)

    spec = P(None, "seq")
    want = np.asarray(jax.jit(shard_map(
        jfn, mesh=jmesh, in_specs=(spec, spec, spec, P()), out_specs=spec,
        check_rep=False))(*(jnp.asarray(a) for a in (q, k, v, k_lens))))
    shards = [torch.from_numpy(a).chunk(4, dim=1) for a in (q, k, v)]
    with torch.no_grad():
        outs = run_ranks(lambda c: ring.ring_self_attention(
            *(s[c.rank] for s in shards), torch.from_numpy(k_lens), c,
            compute_dtype=torch.float32), thread_mesh(seq=4))
    got = torch.cat(outs, dim=1).numpy()
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_ring_merge_of_an_empty_partial():
    """``ring_merge`` with a partial that attended to nothing (the stats a
    fully masked key shard gives) leaves the accumulator as it was, and a
    first step from the empty accumulator takes the partial as it is."""
    rng = np.random.default_rng(4)
    o = torch.from_numpy(rng.standard_normal((1, 5, 2, 8)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((1, 5, 2)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 3, (1, 5, 2)).astype(np.float32))
    empty = (torch.zeros_like(o), torch.full_like(m, -1e30 / LOG2E),
             torch.zeros_like(l))
    got = ring.ring_merge(o, m, l, *empty)
    torch.testing.assert_close(got[0], o, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[1], m) and torch.equal(got[2], l)
    start = (torch.zeros_like(o), torch.full_like(m, -1e30),
             torch.zeros_like(l))
    got = ring.ring_merge(*start, o, m, l)
    torch.testing.assert_close(got[0], o, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[1], m) and torch.equal(got[2], l)


def _rel_norm(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("std,old_ratio", [(1.0, 0.9), (3.0, 0.5)])
def test_ring_carries_the_softmax_in_bf16(std, old_ratio):
    """The ring's rounding in bf16, over 4 thread ranks and 4 key shards
    of 512 keys (B = 1, N = 4, D = 128), q and k drawn diffuse (std 1) or
    peaked (std 3). ``ring_self_attention`` carries the online softmax
    through the forward in fp32 and rounds each output once; the old
    ring, rebuilt here from ``flash_attention_stats_plain`` and
    ``ring_merge``, rounded each shard's partial to bf16 before an fp32
    merge. Against fp64 attention the new ring is as accurate as one pass
    of the twin over all keys (measured 1.0000-1.0012 of its error over
    three seeds; bound 1.01); against that pass it is closer than the old
    ring (measured 0.770-0.774 of the old ring's difference diffuse,
    0.289-0.295 peaked; bounds 0.9 and 0.5). What is left is P's bf16
    rounding against a running max reached in another key order."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2048, 4, 128))
                                * s).to(torch.bfloat16)
               for s in (std, std, 1.0))
    qs, ks, vs = (x.chunk(4, dim=1) for x in (q, k, v))
    with torch.no_grad():
        new = torch.cat(run_ranks(lambda c: ring.ring_self_attention(
            qs[c.rank], ks[c.rank], vs[c.rank], None, c),
            thread_mesh(seq=4)), dim=1)
    old = []
    for r in range(4):
        acc = (torch.zeros(1, 512, 4, 128), torch.full((1, 512, 4), -1e30),
               torch.zeros(1, 512, 4))
        for step in range(4):
            src = (r - step) % 4
            acc = ring.ring_merge(*acc, *tfa.flash_attention_with_stats(
                qs[r], ks[src], vs[src]))
        old.append(acc[0].to(torch.bfloat16))
    old = torch.cat(old, dim=1)
    one = tfa.flash_attention_plain(q, k, v)
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    exact = (torch.softmax(qd @ kd.transpose(-1, -2) * 128 ** -0.5, -1)
             @ vd).transpose(1, 2)
    assert new.dtype == torch.bfloat16
    assert _rel_norm(new, exact) <= 1.01 * _rel_norm(one, exact)
    assert _rel_norm(new, one) <= old_ratio * _rel_norm(old, one)


@pytest.mark.parametrize("sp_mode,ring_n,seq", [
    ("ring", 2, 1), ("ring", 4, 1), ("usp", 2, 1), ("usp", 2, 2)])
def test_ring_walks_the_keys_as_one_pass(sp_mode, ring_n, seq):
    """Ring and USP attention over thread ranks (sp = ring · seq of 2 and
    4) in bf16, every ring shard 128 · seq keys (whole ``KEY_TILE``s),
    batch entry 1's keys ending 28 keys before its last ring shard: a
    masked tail, a partial shard, and a last shard wholly empty. Each
    rank walks the key shards in natural order, so every query row is
    one pass of the twin over all keys at ``KEY_TILE``, bit for bit."""
    sp = ring_n * seq
    n_tok = tfa.KEY_TILE * sp
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n_tok, 4, 32))
                                * s).to(torch.bfloat16)
               for s in (3.0, 3.0, 1.0))
    k_lens = torch.tensor([n_tok, n_tok - n_tok // ring_n - 28])
    want = tfa.flash_attention_stats_plain(q, k, v, k_lens,
                                           block_k=tfa.KEY_TILE)[0]
    shards = [x.chunk(sp, dim=1) for x in (q, k, v)]
    comms = thread_mesh(ring=ring_n, seq=seq) if sp_mode == "usp" \
        else thread_mesh(seq=ring_n)

    def rank(c):
        fn = ulysses._self_attn_fn(c, sp_mode, "auto", torch.bfloat16)
        i = c.axis_index(sharding.shard_axis(c))
        return fn(*(s[i] for s in shards), k_lens)

    with torch.no_grad():
        got = torch.cat(run_ranks(rank, comms), dim=1)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("sp", [1, 2, 3, 4, 8])
def test_natural_order_holds_at_most_sp_minus_one_shards(sp):
    """``ring.natural_order``: every rank attends to the shards 0 … sp − 1
    in that order, each after it has arrived (rank me holds shard
    (me + s) % sp from step s on); rank 0 one a step, holding none; no
    rank holds more than sp − 1 shards waiting for their turn (rank 1
    holds exactly that many before shard 0 reaches it)."""
    most = []
    for me in range(sp):
        steps = ring.natural_order(sp, me)
        assert len(steps) == sp and sum(steps, []) == list(range(sp))
        arrived, done, held = set(), 0, 0
        for s, todo in enumerate(steps):
            arrived.add((me + s) % sp)
            assert set(todo) <= arrived
            done += len(todo)
            held = max(held, s + 1 - done)
        most.append(held)
        if me == 0:
            assert steps == [[j] for j in range(sp)]
    assert most[0] == 0 and max(most) == max(sp - 1, 0)
    if sp > 1:
        assert most[1] == sp - 1


@pytest.mark.parametrize("sp_mode,mesh,shard", [
    ("ulysses", (1, 1, 2), 32), ("ring", (1, 1, 2), 128),
    ("usp", (1, 2, 2), 128)])
def test_sp_seq_len_pads_ring_shards_to_key_tiles(setup, sp_mode, mesh,
                                                   shard):
    """Under ring and USP the SP forward runs at a multiple of
    ``KEY_TILE · sp`` tokens (64 tokens: 256 over 2 ranks, 512 over 2 × 2),
    so each rank's token shard, and under USP each ring block, is whole
    key tiles; under Ulysses the length stays the caller's. The rule
    itself at r1 (7,800 tokens), 1280×720×81 (75,600) and 1920×832×81
    (131,040) over 4 ranks."""
    assert [sp_seq_len(n, 4, m) for n in (7800, 75600, 131040)
            for m in ("ring", "usp", "ulysses")] == [
        8192, 8192, 7800, 75776, 75776, 75600, 131072, 131072, 131040]
    assert sp_seq_len(72, 2, "ring") == 256
    _, model, x, t, ctx = setup
    seen = []
    make = ulysses._self_attn_fn

    def recording(*a):
        fn = make(*a)

        def attn(q, k, v, kl):
            seen.append((q.shape[1], int(kl[0])))
            return fn(q, k, v, kl)
        return attn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ulysses, "_self_attn_fn", recording)
        _port(model, x, t, ctx, mesh, sp_mode=sp_mode)
    assert set(seen) == {(shard, 64)}


@pytest.mark.parametrize("case", ["heads", "usp_mesh", "seq_len", "mode"])
def test_sp_errors_match_jax(setup, case):
    """What JAX's ``sequence_parallel_forward`` asserts, the port raises
    as ValueError: heads not divisible by the Ulysses degree (4 heads over
    8), usp without a ring axis, a (padded) length not a multiple of sp
    (66 over 4), an unknown mode (a ValueError on both sides)."""
    params, model, x, t, ctx = setup
    mesh, kw = {"heads": ((1, 1, 8), {}),
                "usp_mesh": ((1, 1, 4), dict(sp_mode="usp")),
                "seq_len": ((1, 1, 4), dict(seq_len=66)),
                "mode": ((1, 1, 2), dict(sp_mode="spiral"))}[case]
    data, ring_n, seq = mesh
    jerr = ValueError if case == "mode" else AssertionError
    with pytest.raises(jerr):
        jax_sp_forward(params, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(ctx), JCFG, jax_rope(GRID, JCFG.head_dim),
                       jax_make_mesh(data=data, ring=ring_n, seq=seq),
                       compute_dtype=jnp.float32, attn_backend="xla", **kw)
    with pytest.raises(ValueError), torch.no_grad():
        sequence_parallel_forward(
            model, *(torch.from_numpy(a) for a in (x, t, ctx)),
            rope_3d_freqs(GRID, CFG.head_dim),
            thread_mesh(data=data, ring=ring_n, seq=seq)[0],
            compute_dtype=torch.float32, **kw)


def test_mesh_errors_match_jax():
    """A mesh that needs more ranks than the world has, and a ``data``
    axis that the slices do not divide: ValueError on both sides (the
    port's world here is one gloo rank of this process)."""
    import socket

    import torch.distributed as dist

    with pytest.raises(ValueError):
        jax_make_mesh(data=1, seq=16)
    with pytest.raises(ValueError):
        jax_make_pod_mesh(data=3, seq=2, num_slices=2)
    with pytest.raises(ValueError):
        make_pod_mesh(data=3, seq=2, num_slices=2)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
            make_mesh(data=1, seq=2)
        comm = make_mesh(data=1, seq=1)
        x = torch.arange(24.0).reshape(2, 3, 4)
        assert torch.equal(comm.all_to_all(x, "seq", 2, 1), x)
        assert torch.equal(comm.all_gather(x, ("ring", "seq"), 1), x)
    finally:
        dist.destroy_process_group()


def test_param_specs_follow_jax(setup):
    """The port's shard dims are the JAX specs' axes on the transposed
    ([out, in]) weights: every sharded JAX block kernel maps to one port
    weight, cut along the other dimension index."""
    params, model, *_ = setup
    from moviigen_tpu.parallel.sharding import dit_param_specs as jspecs

    js = jspecs(params, axis="seq")["blocks"]
    spec = sharding.dit_param_specs(model)
    names = {"self_attn": "self_attn", "cross_attn": "cross_attn",
             "ffn": None}
    want = {}
    for group, mats in js.items():
        if group not in names:
            continue
        for mat, leaves in mats.items():
            if "kernel" not in leaves or "seq" not in tuple(
                    leaves["kernel"]):
                continue
            jdim = tuple(leaves["kernel"]).index("seq") - 1  # layer axis
            owner = f"ffn_{mat}" if group == "ffn" else f"{group}.{mat}"
            for i in range(CFG.num_layers):
                want[f"blocks.{i}.{owner}.weight"] = 1 - jdim
    assert spec == want
