"""Training under sequence parallelism in the port, on thread ranks
(``ThreadComm``), at t2v-tiny: the ring attention's backward against
``jax.grad`` through the JAX ring, each collective's backward against
autograd of the one-process function it stands for, and the SP train
step (Ulysses, ring, USP; block weights as shards gathered per block,
remat) against JAX's USP step and against the port's one-process step;
clipping, replicas, mesh checkpoints and QLoRA under SP.

Bounds: in fp32 the SP step and the one-process step do the same
arithmetic split over ranks and summed in other orders (the ring's merge,
the reduce-scatters and all-reduces of the gradients), so every gradient
agrees to 1e-5 of its norm (measured: ~1e-6). A gradient scaled by the
world size (the reduce-scatter where the output gather must slice) is off
by O(1) of it. ``test_torch_sp_training_dist.py`` holds ``DistComm``
over gloo to the same results."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from moviigen_tpu.diffusion import flow_match as jfm
from moviigen_tpu.parallel import ring as jring
from moviigen_tpu.parallel.mesh import make_mesh as jax_make_mesh
from moviigen_tpu.ops.rope import rope_3d_freqs as jax_rope
from moviigen_tpu.training import train_step as jts
from moviigen_tpu_torch.convert import wan_params_tree
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops.quantization import QuantLinear
from moviigen_tpu_torch.ops.rope import rope_3d_freqs
from moviigen_tpu_torch.parallel import ring, sharding
from moviigen_tpu_torch.parallel.comm import (Comm, own_trained, run_ranks,
                                              thread_mesh)
from moviigen_tpu_torch.training import (TrainConfig, make_optimizer,
                                         make_train_step)
from moviigen_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
from moviigen_tpu_torch.training.lora import attach_lora, init_lora_params
from moviigen_tpu_torch.training.train_step import (global_norm,
                                                    mesh_global_norm)
from test_torch_training import CFG, GRID, JCFG, make_batch, norm_rel

GRAD_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _state():
    """The port's random init with a live head, made once (never
    written: every user loads it into a model of its own)."""
    gen = torch.Generator().manual_seed(0)
    model = WanModel(CFG, dtype=torch.float32).init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.1, generator=gen)
        model.head.bias.normal_(0.0, 0.1, generator=gen)
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def _model(quant=None):
    model = WanModel(CFG, dtype=torch.float32, quant=quant)
    model.load_state_dict(_state(), strict=quant is None)
    return model


class GradCapture:
    """An optimizer stand-in that keeps the gradients by name; on a mesh
    rank (``comm``) its norm is the mesh's, as ``make_optimizer``'s."""

    def __init__(self, named, comm=None):
        self.names = list(named)
        self.params = list(named.values())
        self.grads = None
        self.norm_fn = global_norm if comm is None else \
            mesh_global_norm(comm, self.params)

    def step(self, grads, norm=None):
        self.grads = dict(zip(self.names, grads))
        return True


def _draws(b=2, seed=5):
    latents, context = make_batch(b=b)
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.standard_normal(latents.shape)
                             .astype(np.float32))
    u = torch.from_numpy(rng.uniform(0.05, 0.95, b).astype(np.float32))
    batch = {"latents": torch.from_numpy(latents),
             "context": torch.from_numpy(context)}
    return batch, noise, u


def _jax_draws(key, shape, tc):
    """``make_train_step``'s own draws (train_step.py:177-188), in one
    jitted call (op by op they take seconds to dispatch)."""
    def draw(key):
        k_noise, k_t = jax.random.split(key)
        return (jax.random.normal(k_noise, shape, jnp.float32),
                jfm.compute_density_for_timestep_sampling(
                    k_t, tc.weighting_scheme, shape[0], tc.logit_mean,
                    tc.logit_std, tc.mode_scale))

    return tuple(torch.from_numpy(np.array(a)) for a in jax.jit(draw)(key))


def _rank_model(model, comm):
    return own_trained(sharding.shard_params(
        model, sharding.dit_param_specs(model), comm,
        sharding.shard_axis(comm)))


def _whole(outs, comms, name, dims):
    """Tensor ``name`` of every rank's result dict gathered over the shard
    axes (from the data-0 ranks), or rank 0's where it is not a shard."""
    if name not in dims:
        return outs[0][name]
    ranks = [r for r, c in enumerate(comms) if c.coords["data"] == 0]
    return torch.cat([outs[r][name] for r in ranks], dim=dims[name])


def _one_process_grads(model, tc, batch, noise, u, seq_len=None):
    cap = GradCapture(dict(model.named_parameters()))
    metrics = make_train_step(model, tc, rope_3d_freqs(GRID, CFG.head_dim),
                              cap, seq_len=seq_len,
                              compute_dtype=torch.float32)(
        batch, noise=noise, u=u)
    return metrics, cap.grads


def _sp_grads(model, tc, batch, noise, u, mesh, sp_mode, seq_len=None):
    comms = thread_mesh(**mesh)

    def rank(comm):
        m = _rank_model(model, comm)
        cap = GradCapture(dict(m.named_parameters()), comm)
        metrics = make_train_step(
            m, tc, rope_3d_freqs(GRID, CFG.head_dim), cap, seq_len=seq_len,
            compute_dtype=torch.float32, comm=comm, sp_mode=sp_mode)(
            batch, noise=noise, u=u)
        return metrics, cap.grads, sharding.sharded_tensors(m)

    outs = run_ranks(rank, comms)
    dims = outs[0][2]
    grads = {n: _whole([o[1] for o in outs], comms, n, dims)
             for n in outs[0][1]}
    return outs[0][0], grads, outs


# ------------------------------------------------ the ring's backward


@pytest.mark.parametrize("sp,k_lens", [(2, (48, 20)), (4, (48, 27))])
def test_ring_backward_matches_jax_grad(sp, k_lens):
    """dq, dk, dv of the port's ring (``RingAttention``, the plain pair
    backward on the CPU) against ``jax.grad`` through JAX's ring
    (``attn_backend="xla"``: plain autodiff through the rotations) on its
    mesh, with batch entry 1's last key shard empty (k_len 0 there), and
    the empty pair adding exactly nothing. fp32: within 1e-5 of each
    gradient's largest value."""
    rng = np.random.default_rng(sp)
    q, k, v, w = (rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
                  for _ in range(4))
    k_lens = np.asarray(k_lens, np.int32)
    jmesh = jax_make_mesh(data=1, seq=sp)
    spec = P(None, "seq")

    def jloss(q, k, v):
        out = shard_map(
            lambda q, k, v, kl: jring.ring_self_attention(
                q, k, v, kl, axis_name="seq", sp_size=sp,
                attn_backend="xla", compute_dtype=jnp.float32),
            mesh=jmesh, in_specs=(spec, spec, spec, P()), out_specs=spec,
            check_rep=False)(q, k, v, jnp.asarray(k_lens))
        return jnp.sum(out * jnp.asarray(w))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    shards = [torch.from_numpy(a).chunk(sp, dim=1) for a in (q, k, v, w)]

    def rank(comm):
        xs = [s[comm.rank].clone().requires_grad_() for s in shards[:3]]
        out = ring.ring_self_attention(*xs, torch.from_numpy(k_lens), comm,
                                       compute_dtype=torch.float32)
        return torch.autograd.grad(out, xs, shards[3][comm.rank])

    outs = run_ranks(rank, thread_mesh(seq=sp))
    for i, name in enumerate("qkv"):
        got = torch.cat([o[i] for o in outs], dim=1).numpy()
        ref = np.asarray(want[i])
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), name
    # keys at or past k_len have exactly zero dk and dv
    for i in (1, 2):
        got = torch.cat([o[i] for o in outs], dim=1)
        assert not bool(got[1, k_lens[1]:].any())


# ------------------------------------------------ the collectives


def _a2a(xs, r, n):
    c = xs[0].shape[2] // n
    return torch.cat([x.narrow(2, r * c, c) for x in xs], dim=1)


def _rs(xs, r, n):
    c = xs[0].shape[1] // n
    out = xs[0].narrow(1, r * c, c)
    for x in xs[1:]:
        out = out + x.narrow(1, r * c, c)
    return out


def _total(xs, r, n):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


# name, the rank's op, the one-process function giving rank r's output
# from every rank's input, and how the inputs / cotangents relate:
# "own" (each rank its own), "alike_in" (one value every rank holds),
# "alike_out" (one loss every rank computes alike: equal cotangents).
COLLECTIVES = [
    ("all_to_all", lambda c, x: c.all_to_all(x, "seq", 2, 1), _a2a, "own"),
    ("ring_shift", lambda c, x: c.ring_shift(x, "seq"),
     lambda xs, r, n: xs[(r - 1) % n], "own"),
    ("all_gather", lambda c, x: c.all_gather(x, "seq", 1),
     lambda xs, r, n: torch.cat(xs, dim=1), "own"),
    ("reduce_scatter", lambda c, x: c.reduce_scatter(x, "seq", 1), _rs,
     "own"),
    ("all_reduce", lambda c, x: c.all_reduce(x, "seq"), _total, "own"),
    ("shard", lambda c, x: c.shard(x, "seq", 1),
     lambda xs, r, n: xs[0].narrow(1, r * (xs[0].shape[1] // n),
                                   xs[0].shape[1] // n), "alike_in"),
    ("unshard", lambda c, x: c.unshard(x, "seq", 1),
     lambda xs, r, n: torch.cat(xs, dim=1), "alike_out"),
    ("replicate", lambda c, x: c.replicate(x, "seq"),
     lambda xs, r, n: xs[0], "alike_in"),
]


@pytest.mark.parametrize("name,op,one,kind", COLLECTIVES,
                         ids=[c[0] for c in COLLECTIVES])
def test_collective_backward_matches_one_process(name, op, one, kind):
    """Each differentiable collective over 4 thread ranks: the forward is
    the one-process function it stands for, and each rank's input
    gradient is autograd's through that function (with one input for a
    value every rank holds alike, one loss for outputs every rank uses
    alike). Within 1e-6 of the scale (fp32 sums in rank order)."""
    n = 4
    rng = np.random.default_rng(len(name))
    xs = [torch.from_numpy(rng.standard_normal((2, 8, 4, 3))
                           .astype(np.float32)) for _ in range(n)]
    if kind == "alike_in":
        xs = [xs[0]] * n
    outs0 = [one(xs, r, n) for r in range(n)]
    gs = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
          for o in outs0]
    if kind == "alike_out":
        gs = [gs[0]] * n

    def rank(comm):
        x = xs[comm.rank].clone().requires_grad_()
        out = op(comm, x)
        return out.detach(), torch.autograd.grad(out, x, gs[comm.rank])[0]

    got = run_ranks(rank, thread_mesh(seq=n))
    leaves = [x.clone().requires_grad_() for x in
              (xs[:1] if kind == "alike_in" else xs)]
    outs = [one(leaves if kind != "alike_in" else leaves * n, r, n)
            for r in range(n)]
    if kind == "alike_out":  # one loss, counted once
        loss = torch.sum(outs[0] * gs[0])
    else:
        loss = sum(torch.sum(o * g) for o, g in zip(outs, gs))
    want = torch.autograd.grad(loss, leaves)
    for r in range(n):
        assert torch.allclose(got[r][0], outs0[r], rtol=0, atol=1e-6)
        ref = want[0] if kind == "alike_in" else want[r]
        assert torch.allclose(got[r][1], ref, rtol=0,
                              atol=1e-6 * float(ref.abs().max())), r


# ------------------------------------------------ the SP train step


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process fp32 step: loss and gradients, remat in
    groups of 2, the token count padded to 64 (the ring's last shard
    empty where 4 shards split it)."""
    model = _model()
    batch, noise, u = _draws()
    tc = TrainConfig(remat=True, remat_group=2)
    metrics, grads = _one_process_grads(model, tc, batch, noise, u,
                                        seq_len=64)
    return model, tc, batch, noise, u, metrics, grads


@pytest.mark.parametrize("sp_mode,mesh", [
    ("ulysses", dict(data=2, seq=2)),
    ("ring", dict(data=1, seq=4)),
    ("usp", dict(data=2, ring=2, seq=2)),
], ids=["ulysses_2x2", "ring_4", "usp_2x2x2"])
def test_sp_train_step_grads_equal_one_process(one_process, sp_mode, mesh):
    """The SP train step over thread ranks, block weights as shards
    gathered per block inside the checkpointed blocks (remat, remat_group
    2): loss, grad_norm and every gradient (the shards gathered) equal
    the one-process step's within 1e-5 of each gradient's norm. Negative
    control: the gradients times the world size fail that bound."""
    model, tc, batch, noise, u, m1, want = one_process
    metrics, grads, _ = _sp_grads(model, tc, batch, noise, u, mesh,
                                  sp_mode, seq_len=64)
    world = int(np.prod(list(mesh.values())))
    assert float(metrics["loss"]) == pytest.approx(float(m1["loss"]),
                                                   rel=1e-6)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(m1["grad_norm"]), rel=1e-5)
    assert set(grads) == set(want)
    for name, w in want.items():
        assert bool(w.abs().max() > 0), name  # the live head reaches it
        assert norm_rel(grads[name], w) <= GRAD_TOL, name
        assert norm_rel(grads[name] * world, w) > GRAD_TOL, name


def test_output_gather_that_sums_fails_the_bound(one_process, monkeypatch):
    """Negative control of the output gather's backward: with
    ``Comm.unshard`` replaced by the all-gather (a reduce-scatter
    backward) every block gradient comes out ``world`` times too large,
    far outside the bound."""
    model, tc, batch, noise, u, _, want = one_process
    monkeypatch.setattr(Comm, "unshard", Comm.all_gather)
    _, grads, _ = _sp_grads(model, tc, batch, noise, u, dict(seq=2),
                            "ulysses", seq_len=64)
    name = "blocks.0.self_attn.q.weight"
    assert norm_rel(grads[name], 2 * want[name]) <= GRAD_TOL
    assert norm_rel(grads[name], want[name]) > 0.5


def test_usp_train_step_loss_matches_jax():
    """The port's USP step on a (data 2, ring 2, seq 2) mesh against the
    JAX ``make_train_step(..., mesh=make_mesh(data=2, ring=2, seq=2))``
    with the same weights and JAX's draws replayed (bf16 compute on both
    sides, as in ``test_torch_training.py``: loss within 1e-2, grad_norm
    within 2e-2)."""
    model = _model()
    params = jax.tree_util.tree_map(jnp.asarray, wan_params_tree(model))
    latents, context = make_batch(b=2)
    # remat changes no number, only the JAX step's compile time
    tc, jtc = TrainConfig(remat=False), jts.TrainConfig(remat=False)
    key = jax.random.PRNGKey(5)
    jmesh = jax_make_mesh(data=2, ring=2, seq=2)
    step = jts.make_train_step(JCFG, jtc, jax_rope(GRID, JCFG.head_dim),
                               attn_backend="xla", mesh=jmesh)
    _, opt_state = jts.init_train_state(params, jtc)
    with jmesh:
        _, _, jm = jax.jit(step)(params, opt_state,
                                 {"latents": jnp.asarray(latents),
                                  "context": jnp.asarray(context)}, key)
    noise, u = _jax_draws(key, latents.shape, tc)
    batch = {"latents": torch.from_numpy(latents),
             "context": torch.from_numpy(context)}

    def rank(comm):
        m = _rank_model(model, comm)
        cap = GradCapture(dict(m.named_parameters()), comm)
        return make_train_step(m, tc, rope_3d_freqs(GRID, CFG.head_dim),
                               cap, comm=comm)(batch, noise=noise, u=u)

    outs = run_ranks(rank, thread_mesh(data=2, ring=2, seq=2))
    for got in outs:
        assert float(got["loss"]) == pytest.approx(float(jm["loss"]),
                                                   rel=1e-2)
        assert float(got["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=2e-2)
        assert torch.equal(got["loss"], outs[0]["loss"])


# ------------------------------------------------ clip, replicas, ckpts


def _train(model, tc, draws, comms, sp_mode, steps, keep=None):
    """``steps`` SP steps with AdamW on every rank of ``comms``; returns
    each rank's (model, optimizer, metrics list)."""

    def rank(comm):
        m = _rank_model(model, comm)
        opt = make_optimizer(list(m.parameters()), tc, comm=comm)
        step = make_train_step(m, tc, rope_3d_freqs(GRID, CFG.head_dim),
                               opt, compute_dtype=torch.float32, comm=comm,
                               sp_mode=sp_mode)
        metrics = [step(draws[i][0], noise=draws[i][1], u=draws[i][2])
                   for i in range(steps)]
        return m, opt, metrics

    return run_ranks(rank, comms)


def test_clipped_updates_equal_one_process_and_replicas_stay_equal():
    """Two SP steps (Ulysses, data 2 × seq 2) with ``max_grad_norm``
    below the gradient norm, so both clip: the updated parameters (the
    shards gathered) equal the one-process updates within 1e-5 of each
    update's norm plus one fp32 ulp of the parameter, and every rank's
    replicated tensors, and the data ranks' shards, are bit-equal. eps = 1
    keeps the update linear in the clipped gradient (see
    ``test_torch_training.py::test_train_step_matches_jax``)."""
    model = _model()
    tc = TrainConfig(learning_rate=1e-3, eps=1.0, max_grad_norm=0.1)
    draws = [_draws(seed=5), _draws(seed=6)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    one = _model()
    opt = make_optimizer(list(one.parameters()), tc)
    step = make_train_step(one, tc, rope_3d_freqs(GRID, CFG.head_dim), opt,
                           compute_dtype=torch.float32)
    norms = [float(step(b, noise=n, u=u)["grad_norm"]) for b, n, u in draws]
    assert min(norms) > 10 * tc.max_grad_norm  # both steps clip

    comms = thread_mesh(data=2, seq=2)
    outs = _train(model, tc, draws, comms, "ulysses", 2)
    dims = sharding.sharded_tensors(outs[0][0])
    named = [dict(m.named_parameters()) for m, _, _ in outs]
    for r in range(1, 4):
        for name, p in named[r].items():
            # the first rank that holds the same tensor (or shard)
            q = next(q for q in range(4) if name not in dims
                     or comms[q].axis_index("seq")
                     == comms[r].axis_index("seq"))
            assert torch.equal(p, named[q][name]), (r, name)
    for name, p in one.named_parameters():
        got = _whole(named, comms, name, dims).detach() - before[name]
        ref = p.detach() - before[name]
        ulp = np.linalg.norm(np.spacing(before[name].numpy()))
        assert float((got - ref).norm()) <= \
            GRAD_TOL * float(ref.norm()) + ulp, name
    for (_, _, metrics), want in zip(outs, [norms] * 4):
        assert [float(m["grad_norm"]) for m in metrics] == \
            pytest.approx(want, rel=1e-5)


def test_mesh_checkpoint_round_trip_and_resume(tmp_path):
    """Gradient accumulation over 2 micro-batches under a (1, 2) mesh:
    micro-batch 1 holds the parameters; a mesh checkpoint written then
    (the accumulated gradient inside) restores bit for bit into fresh rank
    models and optimizers, and micro-batch 2 from it gives the same bits
    as the uninterrupted run. The checkpoint is in the one-process
    layout: ``restore_checkpoint`` in one process reads the gathered
    parameters and the optimizer state."""
    model = _model()
    tc = TrainConfig(learning_rate=1e-3, grad_accum_steps=2)
    draws = [_draws(seed=5), _draws(seed=6)]
    comms = thread_mesh(seq=2)
    rope = rope_3d_freqs(GRID, CFG.head_dim)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    def run(comm, resume):
        m = _rank_model(model, comm)
        opt = make_optimizer(list(m.parameters()), tc, comm=comm)
        step = make_train_step(m, tc, rope, opt, comm=comm,
                               compute_dtype=torch.float32)
        saved = None
        if resume:
            got = restore_checkpoint(resume, m, opt, comm=comm)
            assert got == 1 and opt.mini_step == 1 and opt.count == 0
        else:
            step(draws[0][0], noise=draws[0][1], u=draws[0][2])
            save_checkpoint(str(tmp_path), 1, m, opt, comm=comm)
            saved = ({n: p.detach().clone() for n, p in m.named_parameters()},
                     [a.clone() for a in opt.acc])
        state = ({n: p.detach().clone() for n, p in m.named_parameters()},
                 [a.clone() for a in opt.acc])
        step(draws[1][0], noise=draws[1][1], u=draws[1][2])
        return saved, state, {n: p.detach().clone()
                              for n, p in m.named_parameters()}, \
            sharding.sharded_tensors(m)

    first = run_ranks(lambda c: run(c, None), comms)
    path = str(tmp_path / "checkpoint-step_1")
    resumed = run_ranks(lambda c: run(c, path), comms)
    for (saved, _, after, dims), (_, state, again, _) in zip(first, resumed):
        for name, p in saved[0].items():
            assert torch.equal(state[0][name], p), name  # round trip
            assert torch.equal(again[name], after[name]), name  # resume
            if name not in dims:  # micro-batch 1 held the parameters
                assert torch.equal(p, start[name]), name
        for a, b in zip(saved[1], state[1]):
            assert torch.equal(a, b)
        assert any(not torch.equal(after[n], saved[0][n]) for n in after)

    one = _model()
    opt = make_optimizer(list(one.parameters()), tc)
    assert restore_checkpoint(path, one, opt) == 1
    dims = first[0][3]
    for name, p in one.named_parameters():
        want = _whole([f[0][0] for f in first], comms, name, dims)
        assert torch.equal(p, want), name
    assert opt.mini_step == 1
    names = [n for n, _ in one.named_parameters()]
    # each rank's accumulated gradients, in its parameters' order
    accs = [dict(zip(f[0][0], f[0][1])) for f in first]
    for i, name in enumerate(names):
        assert torch.equal(opt.acc[i], _whole(accs, comms, name, dims)), name


def test_one_process_checkpoint_resumes_on_a_mesh(tmp_path):
    """A checkpoint written in one process after one AdamW update (the
    one format: ``opt_state.safetensors``) restores on a (1, 2) mesh:
    each rank's parameters and moments are bit-equal to its slice of the
    one-process tensors (the whole of each replicated one), and the
    counters come back."""
    tc = TrainConfig(learning_rate=1e-3)
    batch, noise, u = _draws()
    one = _model()
    opt = make_optimizer(list(one.parameters()), tc)
    make_train_step(one, tc, rope_3d_freqs(GRID, CFG.head_dim), opt,
                    compute_dtype=torch.float32)(batch, noise=noise, u=u)
    path = save_checkpoint(str(tmp_path), 1, one, opt)
    index = {n: i for i, (n, _) in enumerate(one.named_parameters())}

    def rank(comm):
        m = _rank_model(_model(), comm)
        mine = make_optimizer(list(m.parameters()), tc, comm=comm)
        assert restore_checkpoint(path, m, mine, comm=comm) == 1
        dims, i = sharding.sharded_tensors(m), comm.axis_index("seq")
        for k, (name, p) in enumerate(m.named_parameters()):
            for got, want in ((p, dict(one.named_parameters())[name]),
                              (mine.m[k], opt.m[index[name]]),
                              (mine.v[k], opt.v[index[name]])):
                if name in dims:
                    c = got.shape[dims[name]]
                    want = want.narrow(dims[name], i * c, c)
                assert torch.equal(got, want), name
        return mine.count, mine.mini_step

    assert run_ranks(rank, thread_mesh(seq=2)) == [(1, 0), (1, 0)]


def test_qlora_under_sp_matches_one_process():
    """QLoRA over a (1, 2) mesh, as ``tests/test_training.py::
    test_qlora_train_step_sequence_parallel``: an int4 base (codes and
    scales sharded, gathered per block as bytes), rank-2 adapters
    replicated. The adapter gradients equal the one-process gradients
    within 1e-5 of their norm (adapters with a live B, so that every A
    has a gradient), and the loss falls over 3 SP steps at lr 1e-2."""
    gen = torch.Generator().manual_seed(1)
    model = WanModel(CFG, dtype=torch.float32, quant="int4")
    model.init_weights(gen)
    with torch.no_grad():  # a live head
        model.head.weight.copy_(_state()["head.weight"])
        model.head.bias.copy_(_state()["head.bias"])
    model.requires_grad_(False)
    adapters = init_lora_params(model, rank=2, generator=gen)
    with torch.no_grad():
        for ad in adapters.values():
            ad.B.normal_(0.0, 0.1, generator=gen)
    attach_lora(model, adapters, alpha=2.0, rank=2)
    batch, noise, u = _draws()
    tc = TrainConfig(learning_rate=1e-2, remat=True)
    rope = rope_3d_freqs(GRID, CFG.head_dim)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert len(named) == 2 * len(adapters)
    cap = GradCapture(named)
    make_train_step(model, tc, rope, cap, compute_dtype=torch.float32)(
        batch, noise=noise, u=u)
    want = cap.grads

    def rank(comm):
        m = _rank_model(model, comm)
        assert any(isinstance(x, QuantLinear) and "_shard_dims" in x.__dict__
                   for x in m.modules())
        mine = {n: p for n, p in m.named_parameters() if p.requires_grad}
        rc = GradCapture(mine, comm)
        make_train_step(m, tc, rope, rc, compute_dtype=torch.float32,
                        comm=comm)(batch, noise=noise, u=u)
        opt = make_optimizer(list(mine.values()), tc, comm=comm)
        step = make_train_step(m, tc, rope, opt,
                               compute_dtype=torch.float32, comm=comm)
        losses = [float(step(batch, noise=noise, u=u)["loss"])
                  for _ in range(3)]
        return rc.grads, losses

    outs = run_ranks(rank, thread_mesh(seq=2))
    for grads, losses in outs:
        assert set(grads) == set(want)
        for name, w in want.items():
            assert bool(w.abs().max() > 0), name
            assert norm_rel(grads[name], w) <= GRAD_TOL, name
        assert losses[-1] < losses[0] and losses == outs[0][1]
