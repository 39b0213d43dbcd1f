"""The port's training path against the JAX package on t2v-tiny: the
train step, the optimizer, remat, the data layer and the finetune CLI.

Every gradient comparison runs with a live head: the zero-initialised
head of both packages makes d pred / d blocks = 0, so every block
gradient would be exactly zero on both sides. ``jax.random``'s draws
cannot be reproduced in torch: the tests replay JAX's own split, normal
and uniform and hand the results to the port's step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.diffusion import flow_match as jfm
from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.ops.rope import rope_3d_freqs as jax_rope
from moviigen_tpu.training import data as jdata
from moviigen_tpu.training import train_step as jts
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.convert import load_wan_params
from moviigen_tpu_torch.diffusion import flow_match as tfm
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops.rope import rope_3d_freqs
from moviigen_tpu_torch.training import (TrainConfig, make_optimizer,
                                         make_train_step)
from moviigen_tpu_torch.training import data as tdata

JCFG = JAX_CONFIGS["t2v-tiny"].model
CFG = WAN_CONFIGS["t2v-tiny"].model
GRID = (2, 4, 4)  # latents [B, 4, 2, 8, 8], patch (1, 2, 2)


def jax_params_live_head(seed=0):
    """JAX init_params (fp32, the CLI's master weights) with a random
    non-zero head, as numpy."""
    params = jax.tree_util.tree_map(
        np.asarray, jwan.init_params(jax.random.PRNGKey(seed), JCFG,
                                     jnp.float32))
    head = params["head"]["head"]
    rng = np.random.default_rng(seed + 100)
    for name in ("kernel", "bias"):
        head[name] = (rng.standard_normal(head[name].shape) * 0.1) \
            .astype(np.float32)
    return params


def port_model(params):
    return load_wan_params(WanModel(CFG, dtype=torch.float32), params)


def named_tree(tree):
    """A JAX-layout tree (params or grads) under the port's names."""
    return {n: p.detach().clone()
            for n, p in port_model(tree).named_parameters()}


def make_batch(b=1, seed=7):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((b, CFG.in_dim, 2, 8, 8)) \
        .astype(np.float32)
    context = rng.standard_normal((b, CFG.text_len, CFG.text_dim)) \
        .astype(np.float32)
    context[:, 9:] = 0.0  # a zero-padded prompt
    return latents, context


def jax_draws(key, shape, tc):
    """``make_train_step``'s own draws (train_step.py:177-188)."""
    k_noise, k_t = jax.random.split(key)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    u = jfm.compute_density_for_timestep_sampling(
        k_t, tc.weighting_scheme, shape[0], tc.logit_mean, tc.logit_std,
        tc.mode_scale)
    return (torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(u)))


class GradCapture:
    """An optimizer stand-in for ``make_train_step`` that keeps the
    gradients and leaves the parameters alone."""

    def __init__(self, model):
        self.params = list(model.parameters())
        self.names = [n for n, _ in model.named_parameters()]
        self.grads = None

    def step(self, grads, norm=None):
        self.grads = dict(zip(self.names, grads))
        return True


def port_grads(model, tc, batch, noise, u, compute_dtype=torch.float32):
    cap = GradCapture(model)
    step = make_train_step(model, tc, rope_3d_freqs(GRID, CFG.head_dim), cap,
                           compute_dtype=compute_dtype)
    metrics = step(batch, noise=noise, u=u)
    return metrics, cap.grads


def norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ------------------------------------------------------------ train step


def test_fp32_loss_and_grads_match_jax():
    """fp32 compute on both sides: loss and every parameter's gradient
    agree to 1e-5 relative (fp32 sums in other orders)."""
    params = jax_params_live_head()
    latents, context = make_batch()
    tc = TrainConfig()
    key = jax.random.PRNGKey(11)
    noise, u = jax_draws(key, latents.shape, tc)
    sig_tab = jfm.train_schedule(tc.num_train_timesteps)[0]
    sigmas = jfm.sigmas_for_timesteps(jnp.asarray(u.numpy()), sig_tab)
    rope = jax_rope(GRID, JCFG.head_dim)

    def loss_fn(p):
        x = jnp.asarray(latents)
        noisy = jfm.flow_match_noisy(x, jnp.asarray(noise.numpy()), sigmas)
        pred = jwan.forward(p, noisy, sigmas * tc.num_train_timesteps,
                            jnp.asarray(context), JCFG, rope,
                            compute_dtype=jnp.float32, attn_backend="xla",
                            remat=True)
        target = jfm.flow_match_target(x, jnp.asarray(noise.numpy()))
        return jnp.mean(jnp.square(pred - target))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = named_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    batch = {"latents": torch.from_numpy(latents),
             "context": torch.from_numpy(context)}
    metrics, grads = port_grads(port_model(params), tc, batch, noise, u)
    assert float(metrics["loss"]) == pytest.approx(float(jloss), rel=1e-5)
    assert set(grads) == set(want)
    for name, w in want.items():
        assert bool(w.abs().max() > 0), name  # the live head reaches it
        assert norm_rel(grads[name], w) <= 1e-5, name


def test_train_step_matches_jax():
    """One full step (bf16 compute, remat, clip, AdamW) of the port
    against ``make_train_step`` with the same draws.

    Tolerances: both sides round the matmul inputs to bf16 but accumulate
    in other orders, so loss and grad_norm agree to ~1e-3 (bounds 1e-2
    and 2e-2). eps = 1 keeps the first AdamW step linear in the gradient
    (u = g/(|g| + 1)); at the default eps it is lr·sign(g), which would
    hide the gradient behind its sign. The parameter updates then carry
    the gradients' bf16 disagreement: 3e-2 of each update's norm, plus
    the fp32 rounding of p + update on each side (one ulp of p per
    element; it dominates where the update is mostly weight decay)."""
    params = jax_params_live_head()
    latents, context = make_batch(b=2)
    kw = dict(learning_rate=1e-3, eps=1.0)
    jtc, tc = jts.TrainConfig(**kw), TrainConfig(**kw)
    key = jax.random.PRNGKey(5)
    step = jts.make_train_step(JCFG, jtc, jax_rope(GRID, JCFG.head_dim),
                               attn_backend="xla")
    _, opt_state = jts.init_train_state(params, jtc)
    jbatch = {"latents": jnp.asarray(latents),
              "context": jnp.asarray(context)}
    new_params, _, jm = jax.jit(step)(params, opt_state, jbatch, key)
    want = named_tree(jax.tree_util.tree_map(np.asarray, new_params))

    model = port_model(params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(list(model.parameters()), tc)
    tstep = make_train_step(model, tc, rope_3d_freqs(GRID, CFG.head_dim),
                            opt)
    noise, u = jax_draws(key, latents.shape, tc)
    tm = tstep({"latents": torch.from_numpy(latents),
                "context": torch.from_numpy(context)}, noise=noise, u=u)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-2)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=2e-2)
    assert float(tm["timestep_mean"]) == pytest.approx(
        float(jm["timestep_mean"]), rel=1e-6)
    assert opt.count == 1
    for name, p in model.named_parameters():
        got = (p.detach() - before[name]).numpy()
        ref = (want[name] - before[name]).numpy()
        assert np.abs(ref).max() > 0, name
        ulp = np.linalg.norm(np.spacing(before[name].numpy()))
        assert np.linalg.norm(got - ref) <= \
            3e-2 * np.linalg.norm(ref) + ulp, name


def test_train_step_draws_from_its_generator():
    """Without overrides the step draws noise and u from the generator it
    was given: two steps from equal generators give equal metrics."""
    params = jax_params_live_head()
    latents, context = make_batch()
    batch = {"latents": torch.from_numpy(latents),
             "context": torch.from_numpy(context)}
    tc = TrainConfig(weighting_scheme="logit_normal")
    out = []
    for _ in range(2):
        model = port_model(params)
        step = make_train_step(
            model, tc, rope_3d_freqs(GRID, CFG.head_dim),
            make_optimizer(list(model.parameters()), tc),
            compute_dtype=torch.float32,
            generator=torch.Generator().manual_seed(3))
        out.append({k: float(v) for k, v in step(batch).items()})
    assert out[0] == out[1]
    assert np.isfinite(out[0]["loss"]) and out[0]["grad_norm"] > 0
    model = port_model(params)
    step = make_train_step(model, tc, rope_3d_freqs(GRID, CFG.head_dim),
                           make_optimizer(list(model.parameters()), tc))
    with pytest.raises(ValueError, match="generator"):
        step(batch)


@pytest.mark.parametrize("scheme", ["uniform", "logit_normal", "mode"])
def test_density_sampling_matches_jax_formula(scheme):
    """The port's draw, pushed through the same formula as JAX's: the
    uniform / normal base draw is reproduced from the generator and the
    transforms agree; u stays in [0, 1]."""
    n = 4096
    u = tfm.compute_density_for_timestep_sampling(
        torch.Generator().manual_seed(0), scheme, n, 0.0, 1.0, 1.29)
    gen = torch.Generator().manual_seed(0)
    if scheme == "logit_normal":
        want = torch.sigmoid(torch.randn(n, generator=gen))
    else:
        base = torch.rand(n, generator=gen)
        want = base
        if scheme == "mode":
            want = torch.from_numpy(np.array(
                1 - jnp.asarray(base.numpy()) - 1.29 * (
                    jnp.cos(jnp.pi * jnp.asarray(base.numpy()) / 2) ** 2
                    - 1 + jnp.asarray(base.numpy()))))
    np.testing.assert_allclose(u.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert u.dtype == torch.float32 and u.shape == (n,)
    sig = tfm.sigmas_for_timesteps(u, tfm.train_schedule(1000, 3.0)[0])
    jsig = jfm.sigmas_for_timesteps(jnp.asarray(u.numpy()),
                                    jfm.train_schedule(1000, 3.0)[0])
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("sched,warmup,accum", [
    ("constant", 2, 1),   # warmup: the first update has lr 0
    ("linear", 0, 1),
    ("cosine", 0, 1),
    ("constant", 0, 2),   # MultiSteps, k = 2
])
def test_optimizer_matches_optax(sched, warmup, accum):
    """Identical gradients for 5 updates: the port's AdamW, clip and
    schedule against the JAX package's optax chain, rtol 1e-6. Even
    micro-steps feed gradients of norm ~10 (clip active), odd ones of
    norm ~0.1 (clip idle)."""
    kw = dict(learning_rate=1e-2, max_train_steps=5, lr_scheduler=sched,
              lr_warmup_steps=warmup, grad_accum_steps=accum)
    jtc, tc = jts.TrainConfig(**kw), TrainConfig(**kw)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    jparams = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()}
    tparams = [torch.from_numpy(jparams[k].copy()) for k in sorted(shapes)]
    start = [p.clone() for p in tparams]
    opt = jts.make_optimizer(jtc)
    state = opt.init(jparams)
    topt = make_optimizer(tparams, tc)
    for s in range(5 * accum):
        scale = 3.0 if s % 2 == 0 else 0.03
        grads = {k: (rng.standard_normal(sh) * scale).astype(np.float32)
                 for k, sh in shapes.items()}
        updates, state = opt.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step([torch.from_numpy(grads[k]) for k in sorted(shapes)])
        for k, p, p0 in zip(sorted(shapes), tparams, start):
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(p.numpy(), want, rtol=1e-6)
            np.testing.assert_allclose((p - p0).numpy(), want - p0.numpy(),
                                       rtol=1e-5, atol=1e-9)
    assert topt.count == 5
    if warmup:  # the first update moved nothing
        assert topt.lr(0) == 0.0


# ------------------------------------------------------------ remat


def _grads_with(tc, params=None, seed=3):
    params = params or jax_params_live_head()
    latents, context = make_batch(seed=seed)
    batch = {"latents": torch.from_numpy(latents),
             "context": torch.from_numpy(context)}
    noise = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        latents.shape).astype(np.float32))
    u = torch.tensor([0.37], dtype=torch.float32)
    return port_grads(port_model(params), tc, batch, noise, u)


def test_remat_grads_match_no_remat():
    """Per-block recompute (torch.utils.checkpoint) gives the same
    gradients bit for bit, and so does ``remat_group=2`` (the
    counterpart of tests/test_training.py::
    test_remat_group_grads_match_per_layer)."""
    params = jax_params_live_head()
    m0, g0 = _grads_with(TrainConfig(remat=False), params)
    for tc in (TrainConfig(remat=True), TrainConfig(remat=True,
                                                    remat_group=2)):
        m1, g1 = _grads_with(tc, params)
        assert float(m1["loss"]) == float(m0["loss"])
        for name in g0:
            assert torch.equal(g1[name], g0[name]), name


def test_remat_group_must_divide_the_stack():
    with pytest.raises(ValueError, match="remat_group"):
        _grads_with(TrainConfig(remat=True,
                                remat_group=CFG.num_layers + 1))


def test_bf16_residual_train_step_matches_fp32():
    """residual_dtype='bfloat16' tracks the fp32 residual stream (the
    counterpart of tests/test_training.py::
    test_bf16_residual_train_step_matches_fp32, with its tolerances)."""
    out = {}
    for rdt in ("float32", "bfloat16"):
        m, _ = _grads_with(TrainConfig(remat=True, residual_dtype=rdt))
        out[rdt] = (float(m["loss"]), float(m["grad_norm"]))
        assert np.isfinite(out[rdt]).all()
    assert out["bfloat16"][0] == pytest.approx(out["float32"][0], rel=2e-2)
    assert out["bfloat16"][1] == pytest.approx(out["float32"][1], rel=5e-2)


# ------------------------------------------------------------ data


@pytest.fixture()
def tiny_dataset(tmp_path):
    """A synthetic latent cache in the reference layout: 12 items, two
    aspect-ratio bins, three lengths, prompts shorter and longer than
    txt_max_len."""
    d = tmp_path / "ds"
    (d / "latent").mkdir(parents=True)
    (d / "prompt_embed").mkdir()
    annos = []
    rng = np.random.default_rng(0)
    for i in range(12):
        np.save(d / "latent" / f"v{i}.npy",
                rng.standard_normal((4, 3, 8, 8)).astype(np.float32))
        np.save(d / "prompt_embed" / f"v{i}.npy",
                rng.standard_normal((5 + 6 * (i % 3), 32))
                .astype(np.float32))
        annos.append({"latent_path": f"v{i}.npy",
                      "prompt_embed_path": f"v{i}.npy",
                      "length": 3 + i % 3, "aspect_ratio_bin": i % 2})
    path = d / "videos2caption.json"
    path.write_text(json.dumps(annos))
    return str(path)


def test_dataset_items_match_jax(tiny_dataset):
    kw = dict(num_latent_t=2, txt_max_len=16, text_dim=32)
    jds = jdata.LatentDataset(tiny_dataset, **kw)
    tds = tdata.LatentDataset(tiny_dataset, **kw)
    assert len(tds) == len(jds) == 12
    assert tds.lengths == jds.lengths
    np.testing.assert_array_equal(tds.aspect_ratios, jds.aspect_ratios)
    for i in range(len(jds)):
        for got, want in zip(tds[i], jds[i]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    items = [tds[i] for i in range(3)]
    for got, want in zip(tdata.latent_collate_function(items),
                         jdata.latent_collate_function(items)):
        np.testing.assert_array_equal(got, want)


def test_collate_pads_ragged_items_as_jax():
    rng = np.random.default_rng(1)
    items = [(rng.standard_normal((4, t, h, w)).astype(np.float32),
              np.ones((16, 32), np.float32), np.ones(16, np.int64))
             for t, h, w in ((2, 8, 8), (3, 6, 8), (1, 8, 4))]
    for got, want in zip(tdata.latent_collate_function(items),
                         jdata.latent_collate_function(items)):
        np.testing.assert_array_equal(got, want)


def test_load_tensor_matches_jax(tmp_path):
    from safetensors.numpy import save_file

    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    np.save(tmp_path / "a.npy", x)
    np.savez(tmp_path / "a.npz", x=x)
    save_file({"x": x}, str(tmp_path / "a.safetensors"))
    torch.save(torch.from_numpy(x), tmp_path / "a.pt")
    for ext in ("npy", "npz", "safetensors", "pt"):
        path = str(tmp_path / f"a.{ext}")
        np.testing.assert_array_equal(tdata.load_tensor(path),
                                      jdata.load_tensor(path))


@pytest.mark.parametrize("name,kw", [
    ("AspectRatioLengthBucketSampler",
     dict(batch_size=2, rank=0, world_size=1)),
    ("AspectRatioLengthBucketSampler",
     dict(batch_size=3, rank=1, world_size=2, drop_last=True,
          num_length_bins=2)),
    ("AspectRatioLengthBucketDistributedSampler",
     dict(batch_size=2, rank=1, world_size=3)),
    ("SPAwareAspectRatioLengthBucketDistributedSampler",
     dict(batch_size=1, rank=3, world_size=4, sp_size=2)),
])
def test_samplers_give_the_jax_order(name, kw):
    lengths = [int(x) for x in np.random.default_rng(4).integers(1, 60, 23)]
    ars = [i % 3 for i in range(23)]
    tsam = getattr(tdata, name)(dataset_size=23, lengths=lengths,
                                aspect_ratios=ars, seed=9, **kw)
    jsam = getattr(jdata, name)(dataset_size=23, lengths=lengths,
                                aspect_ratios=ars, seed=9, **kw)
    assert len(tsam) == len(jsam)
    for epoch in range(3):
        tsam.set_epoch(epoch)
        jsam.set_epoch(epoch)
        assert list(tsam) == list(jsam)


def test_dataloader_batches_match_jax(tiny_dataset):
    kw = dict(num_latent_t=2, txt_max_len=16, text_dim=32)
    samplers = [mod.SPAwareAspectRatioLengthBucketDistributedSampler(
        batch_size=2, dataset_size=12, rank=0, world_size=1, sp_size=1,
        lengths=[3] * 12, aspect_ratios=[i % 2 for i in range(12)], seed=1)
        for mod in (tdata, jdata)]
    tl = tdata.DataLoader(tdata.LatentDataset(tiny_dataset, **kw),
                          samplers[0], batch_size=2)
    jl = jdata.DataLoader(jdata.LatentDataset(tiny_dataset, **kw),
                          samplers[1], batch_size=2, use_native=False)
    tb, jb = list(tl), list(jl)
    assert len(tb) == len(jb) == len(tl) == 6
    for got, want in zip(tb, jb):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_dataloader_stops_its_worker_when_left_early(tiny_dataset):
    """A consumer that breaks out after one batch (the CLI at
    --max_train_steps) leaves no prefetch thread behind."""
    import threading

    ds = tdata.LatentDataset(tiny_dataset, num_latent_t=2, txt_max_len=16,
                             text_dim=32)
    loader = tdata.DataLoader(ds, list(range(12)), batch_size=1, prefetch=1)
    before = set(threading.enumerate())
    it = iter(loader)
    next(it)
    it.close()
    assert set(threading.enumerate()) <= before


def test_dataloader_raises_what_its_worker_raised(tmp_path):
    class Broken:
        def __getitem__(self, i):
            raise OSError("unreadable cache")

    loader = tdata.DataLoader(Broken(), [0, 1], batch_size=1)
    with pytest.raises(OSError, match="unreadable"):
        list(loader)


# ------------------------------------------------------------ CLI


def test_finetune_cli_end_to_end(tiny_dataset, tmp_path):
    """The port's finetune CLI on the CPU: 4 steps, periodic and final
    checkpoints, then resume (as tests/test_training.py::
    test_finetune_cli_end_to_end)."""
    from moviigen_tpu_torch.cli.finetune import main
    from moviigen_tpu_torch.training.checkpoint import latest_checkpoint

    out = tmp_path / "out"
    argv = ["--task", "t2v-tiny", "--device", "cpu",
            "--data_json_path", tiny_dataset, "--num_latent_t", "2",
            "--output_dir", str(out), "--train_batch_size", "2",
            "--max_train_steps", "4", "--checkpointing_steps", "2",
            "--learning_rate", "1e-4", "--gradient_checkpointing"]
    record = main(argv)
    assert record["step"] == 4 and len(record["loss"]) == 4
    assert np.isfinite(record["loss"]).all()
    assert all(g > 0 for g in record["grad_norm"])
    assert (out / "checkpoint-step_2" / "meta.json").exists()
    found = latest_checkpoint(str(out))
    assert found is not None and found[1] == 4
    meta = json.loads((out / "checkpoint-step_4" / "meta.json").read_text())
    assert meta == {"step": 4, "final": True, "lora": False, "quant": "none"}

    # resume continues from step 4 → no step, the final save at 4
    record = main(argv + ["--resume_from_checkpoint", "latest"])
    assert record["step"] == 4 and record["loss"] == []
    # and goes on to step 6 when asked
    record = main(argv[:-5] + ["--max_train_steps", "6",
                               "--checkpointing_steps", "100",
                               "--learning_rate", "1e-4",
                               "--resume_from_checkpoint", "latest"])
    assert record["step"] == 6 and len(record["loss"]) == 2


@pytest.mark.parametrize("flag", [
    ["--use_lora"], ["--quant", "int8"], ["--lora_rank", "8"],
    ["--compute_ot"], ["--sp_size", "2"], ["--ffn_bwd_chunk", "64"],
    ["--attn_bwd_chunk", "64"], ["--profile_steps", "2"],
])
def test_finetune_cli_refuses_later_slices(flag, tiny_dataset):
    from moviigen_tpu_torch.cli.finetune import main

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--task", "t2v-tiny", "--device", "cpu",
              "--data_json_path", tiny_dataset] + flag)
