"""The port's LoRA / QLoRA path against the JAX package on t2v-tiny:
adapters, their side path over full-precision, int8, int4 and W8A8 bases,
the adapter gradients and the train step (the export and the CLIs:
tests/test_torch_lora_cli.py).

The adapters are made once by the JAX ``init_lora_params`` and carried to
the port (``convert.lora_params_to_torch``), then made live
(``jax_adapters``): at init B = 0, so the side path would add nothing and
dA would be exactly zero. Gradient tests use a live head (the
zero-initialised head makes every block gradient zero).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.ops import int8_gemm as jig
from moviigen_tpu.ops import quantization as jq
from moviigen_tpu.ops.rope import rope_3d_freqs as jax_rope
from moviigen_tpu.training import lora as jlora
from moviigen_tpu.training import train_step as jts
from moviigen_tpu_torch.convert import (load_wan_params, lora_params_to_torch,
                                        lora_params_tree)
from moviigen_tpu_torch.models import wan_model as twan
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops.rope import rope_3d_freqs
from moviigen_tpu_torch.training import (TrainConfig, make_optimizer,
                                         make_train_step)
from moviigen_tpu_torch.training import lora as tlora
from moviigen_tpu_torch.training.train_step import global_norm

from test_torch_training import (CFG, GRID, JCFG, jax_draws, make_batch,
                                 norm_rel)

RANK, ALPHA = 4, 8.0  # scale 2: a scale of 1 would hide a missing one


def jax_base(dtype="float32", seed=0):
    """JAX fp32/bf16 init_params with a live head, as numpy."""
    params = jax.tree_util.tree_map(
        np.asarray, jwan.init_params(jax.random.PRNGKey(seed), JCFG,
                                     getattr(jnp, dtype)))
    head = params["head"]["head"]
    rng = np.random.default_rng(seed + 100)
    for name in ("kernel", "bias"):
        head[name] = (rng.standard_normal(head[name].shape) * 0.1) \
            .astype(head[name].dtype)
    return params


def base_pair(quant, dtype="float32"):
    """(JAX tree, the port's model with the same leaves) for a base that
    is full precision (quant None) or quantized (int8 | int4 | w8a8)."""
    params = jax_base(dtype)
    if quant is not None:
        params = jq.quantize_wan_params(params,
                                        bits=4 if quant == "int4" else 8,
                                        act8=quant == "w8a8")
    model = load_wan_params(
        WanModel(CFG, dtype=getattr(torch, dtype), quant=quant), params)
    return params, model.requires_grad_(False)


def jax_adapters(tree, dtype="float32", seed=1):
    """The JAX init with live adapters: A + 0.05 and B ~ N(0, 0.1²). A
    constant B would not do for gradients: dA = xᵀ·dout·Bᵀ then sums dout
    over the channels, which is zero wherever a LayerNorm reads the
    output (the cross-attention o-projection)."""
    lora = jlora.init_lora_params(jax.random.PRNGKey(seed), tree, rank=RANK,
                                  dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(seed)
    return {base: {"A": np.asarray(ab["A"] + 0.05),
                   "B": (rng.standard_normal(ab["B"].shape) * 0.1)
                   .astype(ab["B"].dtype)}
            for base, ab in lora.items()}


def _named(tree):
    """A JAX LoRA tree (adapters, gradients or moments) under the port's
    names, as tensors."""
    return {k: v.detach() for k, v in tlora.lora_state_dict(
        lora_params_to_torch(jax.tree_util.tree_map(np.asarray, tree)))
        .items()}


def _inputs(b=1, seed=7):
    latents, context = make_batch(b=b, seed=seed)
    t = np.full((b,), 537.0, np.float32)
    return latents, t, context


def _forwards(tree, model, lora, cd):
    latents, t, ctx = _inputs()
    want = np.asarray(jwan.forward(
        jlora.attach_lora(tree, lora, alpha=ALPHA, rank=RANK),
        jnp.asarray(latents), jnp.asarray(t), jnp.asarray(ctx), JCFG,
        jax_rope(GRID, JCFG.head_dim), compute_dtype=getattr(jnp, cd),
        attn_backend="xla"))
    rope = rope_3d_freqs(GRID, CFG.head_dim)

    def port():
        with torch.no_grad():
            return model(torch.from_numpy(latents), torch.from_numpy(t),
                         torch.from_numpy(ctx), rope,
                         compute_dtype=getattr(torch, cd),
                         attn_backend="plain").numpy()

    return port, want


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------ adapters


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_init_lora_params_shapes_and_targets(quant):
    """The same targets and per-layer shapes as the JAX init on the same
    base (fp32 kernels, int8 q8 or packed int4 q4 leaves); A ~ N(0, 1)/r
    from the generator, B = 0; the generator decides the draw."""
    tree, model = base_pair(quant)
    want = jlora.init_lora_params(jax.random.PRNGKey(0), tree, rank=RANK)
    got = tlora.init_lora_params(model, rank=RANK,
                                 generator=torch.Generator().manual_seed(0))
    assert len(got) == 8 * CFG.num_layers
    assert set(lora_params_tree(got)) == set(want) \
        == set(jlora.DEFAULT_TARGETS)
    for base, ab in lora_params_tree(got).items():
        assert tuple(ab["A"].shape) == want[base]["A"].shape
        assert tuple(ab["B"].shape) == want[base]["B"].shape
        assert not ab["B"].any()
    a = torch.cat([ad.A.detach().flatten() for ad in got.values()])
    assert abs(float(a.std()) * RANK - 1.0) < 0.05
    again = tlora.init_lora_params(
        model, rank=RANK, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k].A, got[k].A) for k in got)
    assert list(model.parameters())[0].requires_grad is False


def test_convert_round_trip():
    tree, _ = base_pair(None)
    lora = jax_adapters(tree)
    adapters = lora_params_to_torch(lora)
    assert list(adapters)[:2] == ["blocks.0.self_attn.q",
                                  "blocks.0.self_attn.k"]
    back = lora_params_tree(adapters)
    assert set(back) == set(lora)
    for base, ab in lora.items():
        for k in ("A", "B"):
            np.testing.assert_array_equal(back[base][k].numpy(), ab[k])


def test_merge_lora_matches_jax():
    """The merged weights equal the JAX ``merge_lora``'s (fp32, one
    product of A and B each; 1e-6 relative), the model passed in stays
    as it was, and the merged forward is the attached one up to float
    association (x@(W+AB) against x@W + (x@A)@B: 1e-4 of the output)."""
    tree, model = base_pair(None)
    lora = jax_adapters(tree)
    want = jlora.merge_lora(tree, lora, alpha=ALPHA, rank=RANK)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    merged = tlora.merge_lora(model, lora_params_to_torch(lora), ALPHA, RANK)
    wmodel = load_wan_params(WanModel(CFG, dtype=torch.float32),
                             jax.tree_util.tree_map(np.asarray, want))
    for (name, p), (_, w) in zip(merged.named_parameters(),
                                 wmodel.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    tlora.attach_lora(model, lora_params_to_torch(lora), ALPHA, RANK)
    port, _ = _forwards(tree, merged, lora, "float32")
    attached, _ = _forwards(tree, model, lora, "float32")
    np.testing.assert_allclose(port(), attached(),
                               atol=1e-4 * np.abs(attached()).max())
    with pytest.raises(TypeError, match="full-precision"):
        tlora.merge_lora(base_pair("int8")[1], lora_params_to_torch(lora),
                         ALPHA, RANK)


# (base, params dtype, compute dtype, check): fp32 and the weight-only
# bases in fp32 at the plain forward's 5e-4 (test_torch_wan_model.py,
# test_torch_quant_model.py); bf16 and W8A8 as norm-relative bounds whose
# reasons test_torch_quant_model.py gives (bf16 rounding sites over the
# blocks; a flipped activation code under W8A8).
FORWARD_CASES = [
    (None, "float32", "float32", 5e-4),
    (None, "bfloat16", "bfloat16", 3e-2),
    ("int8", "float32", "float32", 5e-4),
    ("int4", "float32", "float32", 5e-4),
    ("int8", "bfloat16", "bfloat16", 3e-2),
    ("w8a8", "float32", "float32", 2e-2),
    ("w8a8", "bfloat16", "bfloat16", 4e-2),
]


@pytest.mark.parametrize("quant,dtype,cd,tol", FORWARD_CASES)
def test_attached_forward_matches_jax(quant, dtype, cd, tol):
    """The DiT forward with adapters attached against JAX ``attach_lora``
    + ``forward`` on the same base and adapters. The adapters change the
    output by much more than the bound, and detaching gives the base's
    output back bit for bit with every base tensor untouched (int8 / int4
    codes included)."""
    tree, model = base_pair(quant, dtype)
    lora = jax_adapters(tree)
    port, want = _forwards(tree, model, lora, cd)
    bare = port()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    tlora.attach_lora(model, lora_params_to_torch(lora), ALPHA, RANK)
    got = port()
    assert np.isfinite(got).all()
    if tol == 5e-4:
        np.testing.assert_allclose(got, want, atol=tol, rtol=1e-3)
    else:
        assert _rel(got, want) < tol
    assert _rel(bare, want) > 3 * tol  # the adapters matter
    taken = tlora.detach_lora(model)
    assert len(taken) == 8 * CFG.num_layers
    assert np.array_equal(port(), bare)
    assert set(model.state_dict()) == set(state)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in state.items())


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_w8a8_dense_side_path_matches_pallas(cd):
    """One W8A8 linear with an adapter: the port's ``_dense`` against the
    JAX int8 kernel (``w8a8_linear``, Pallas in interpret mode), its bias
    added after the cast as the JAX ``_dense`` does, and ``_lora_side``.
    fp32 at the GEMM tests' 1e-6; bf16 within a step (2^-7) where a
    1-ulp fp32 difference flips a rounding."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(128) * 0.3).astype(np.float32)
    q8, scale = jq.quantize_linear(w)
    a = (rng.standard_normal((256, RANK)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((RANK, 128)) * 0.1).astype(np.float32)
    jcd = getattr(jnp, cd)
    base = jig.w8a8_linear(jnp.asarray(x), jnp.asarray(q8),
                           jnp.asarray(scale), None, out_dtype=jcd)
    base = base + jnp.asarray(bias).astype(jcd)
    want = np.asarray(jwan._lora_side(
        {"lora_A": jnp.asarray(a), "lora_B": jnp.asarray(b) * (ALPHA / RANK)},
        jnp.asarray(x), base).astype(jnp.float32))
    lin = twan.QuantLinear(256, 128, act8=True, dtype=getattr(torch, cd))
    lin.qweight.copy_(torch.from_numpy(q8.T.copy()))
    lin.scale.copy_(torch.from_numpy(scale))
    lin.bias.copy_(torch.from_numpy(bias))
    ad = tlora.LoRAAdapter(256, 128, RANK)
    with torch.no_grad():
        ad.A.copy_(torch.from_numpy(a))
        ad.B.copy_(torch.from_numpy(b))
    ad.scale = ALPHA / RANK
    lin.lora = ad
    with torch.no_grad():
        got = twan._dense(lin, torch.from_numpy(x), getattr(torch, cd))
    rtol = 1e-6 if cd == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-5)


def test_attach_refuses_what_does_not_fit():
    _, model = base_pair(None)
    adapters = tlora.init_lora_params(model, rank=RANK)
    tlora.attach_lora(model, adapters, ALPHA, RANK)
    with pytest.raises(ValueError, match="already carries"):
        tlora.attach_lora(model, adapters, ALPHA, RANK)
    tlora.detach_lora(model)
    bad = {"blocks.0.self_attn.q": tlora.LoRAAdapter(8, 8, RANK)}
    with pytest.raises(ValueError, match="does not fit"):
        tlora.attach_lora(model, bad, ALPHA, RANK)
    with pytest.raises(TypeError, match="not a linear"):
        tlora.attach_lora(model, {"blocks.0": bad["blocks.0.self_attn.q"]},
                          ALPHA, RANK)


# ------------------------------------------------------------ training


class GradCapture:
    """An optimizer stand-in for ``make_train_step`` that keeps the
    adapter gradients and leaves the adapters alone."""

    def __init__(self, adapters):
        self.names = list(tlora.lora_state_dict(adapters))
        self.params = list(tlora.lora_parameters(adapters))
        self.grads = None
        self.norm_fn = global_norm

    def step(self, grads, norm=None):
        self.grads = dict(zip(self.names, grads))
        return True


@functools.lru_cache(maxsize=None)
def _jax_adapter_grads(quant):
    """(base, adapters, draws, JAX loss and adapter gradients) of the
    flow-matching loss in fp32 compute through ``attach_lora`` over the
    frozen base. JAX's own tests hold its remat to the same gradients
    (tests/test_training.py), so one JAX program serves every remat
    setting of the port."""
    from moviigen_tpu.diffusion import flow_match as jfm

    tree, _ = base_pair(quant)
    lora = jax_adapters(tree)
    latents, _, context = _inputs()
    noise, u = jax_draws(jax.random.PRNGKey(11), latents.shape,
                         TrainConfig())
    sigmas = jfm.sigmas_for_timesteps(
        jnp.asarray(u.numpy()), jfm.train_schedule(1000)[0])
    rope = jax_rope(GRID, JCFG.head_dim)

    def loss_fn(lr):
        x, nz = jnp.asarray(latents), jnp.asarray(noise.numpy())
        pred = jwan.forward(
            jlora.attach_lora(tree, lr, alpha=ALPHA, rank=RANK),
            jfm.flow_match_noisy(x, nz, sigmas), sigmas * 1000,
            jnp.asarray(context), JCFG, rope, compute_dtype=jnp.float32,
            attn_backend="xla")
        return jnp.mean(jnp.square(pred - jfm.flow_match_target(x, nz)))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(lora)
    return lora, (latents, context, noise, u), float(jloss), _named(jgrads)


@pytest.mark.parametrize("quant,remat,group", [
    (None, False, 1), (None, True, 1), (None, True, 2), ("int8", True, 1)])
def test_adapter_grads_match_jax(quant, remat, group):
    """Adapter gradients of the flow-matching loss in fp32 compute
    against ``jax.grad`` through ``attach_lora`` over the frozen base
    (fp32 or int8 QLoRA), to 1e-5 relative (fp32 sums in other orders).
    With remat the first block's input does not require grad (the
    embeddings are frozen); every adapter still gets its gradient,
    inside ``remat_group`` = 2 too, and no base tensor gets one."""
    lora, (latents, context, noise, u), jloss, want = \
        _jax_adapter_grads(quant)
    _, model = base_pair(quant)
    adapters = lora_params_to_torch(lora)
    tlora.attach_lora(model, adapters, ALPHA, RANK)
    cap = GradCapture(adapters)
    step = make_train_step(model, TrainConfig(remat=remat, remat_group=group),
                           rope_3d_freqs(GRID, CFG.head_dim), cap,
                           compute_dtype=torch.float32)
    metrics = step({"latents": torch.from_numpy(latents),
                    "context": torch.from_numpy(context)}, noise=noise, u=u)
    assert float(metrics["loss"]) == pytest.approx(jloss, rel=1e-5)
    assert set(cap.grads) == set(want)
    for name, w in want.items():
        assert bool(cap.grads[name].abs().max() > 0), name
        assert norm_rel(cap.grads[name], w) <= 1e-5, name
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("lora_dtype", ["float32", "bfloat16"])
def test_lora_train_step_matches_jax(lora_dtype):
    """One step (bf16 compute, remat, clip, AdamW) over the adapters of a
    frozen int8 base against ``make_train_step(..., frozen=...)`` with
    JAX's draws replayed; eps = 1 keeps the first AdamW step linear in
    the gradient (see test_torch_training.py::test_train_step_matches_jax).

    fp32 adapters: loss 1e-2, grad_norm 2e-2, each adapter's update within
    3e-2 of its norm plus an fp32 ulp of the adapter. bf16 adapters and
    moments, as optax keeps them, at lr 0.1 so that the updates are not
    rounded away: each new value is the bf16 rounding of p + u, and u
    follows the bf16 gradient, which agrees with JAX's to ~1e-3 of its
    norm but to a few % at single elements (measured 5 %), so each value
    is within 1e-1 of its update plus two bf16 steps (one per side's
    rounding), and at least 90 % are equal (measured 96-99 %); the first
    moments, bf16 on both sides, within 3e-2 of their norm (measured
    1.2e-2). The base is untouched."""
    tree, model = base_pair("int8")
    lora = jax_adapters(tree, lora_dtype)
    latents, _, context = _inputs(b=2)
    kw = dict(learning_rate=1e-3 if lora_dtype == "float32" else 1e-1,
              eps=1.0, remat=False)  # remat: test_adapter_grads_match_jax
    jtc, tc = jts.TrainConfig(**kw), TrainConfig(**kw)
    key = jax.random.PRNGKey(5)
    jstep = jts.make_train_step(JCFG, jtc, jax_rope(GRID, JCFG.head_dim),
                                attn_backend="xla", lora_alpha=ALPHA,
                                lora_rank=RANK)
    frozen = jax.tree_util.tree_map(jnp.asarray, tree)
    jlr = jax.tree_util.tree_map(jnp.asarray, lora)
    jopt = jts.make_optimizer(jtc)
    new_lora, jstate, jm = jax.jit(jstep)(
        jlr, jopt.init(jlr), {"latents": jnp.asarray(latents),
                              "context": jnp.asarray(context)}, key, frozen)
    want = _named(new_lora)

    adapters = lora_params_to_torch(lora)
    tlora.attach_lora(model, adapters, ALPHA, RANK)
    base = {k: v.clone() for k, v in model.state_dict().items()
            if ".lora." not in k}
    names = tlora.lora_state_dict(adapters)
    before = {k: v.detach().clone() for k, v in names.items()}
    opt = make_optimizer(list(tlora.lora_parameters(adapters)), tc)
    tstep = make_train_step(model, tc, rope_3d_freqs(GRID, CFG.head_dim), opt)
    noise, u = jax_draws(key, latents.shape, tc)
    tm = tstep({"latents": torch.from_numpy(latents),
                "context": torch.from_numpy(context)}, noise=noise, u=u)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-2)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=2e-2)
    for k, v in base.items():
        assert torch.equal(model.state_dict()[k], v), k
    dt = getattr(torch, lora_dtype)
    assert all(m.dtype == dt for m in opt.m + opt.v)
    mus = _named(jstate[1][0].mu)
    for (name, p), m in zip(names.items(), opt.m):
        got = (p.detach() - before[name]).float().numpy()
        ref = (want[name] - before[name]).float().numpy()
        assert np.abs(ref).max() > 0, name
        if lora_dtype == "float32":
            ulp = np.linalg.norm(np.spacing(before[name].numpy()))
            assert np.linalg.norm(got - ref) <= \
                3e-2 * np.linalg.norm(ref) + ulp, name
        else:
            w, b = want[name].float().numpy(), before[name].float().numpy()
            step = np.spacing(np.maximum(np.abs(w), np.abs(b))) * 2 ** 16
            new = p.detach().float().numpy()
            assert (np.abs(new - w) <= 1e-1 * np.abs(ref) + 2 * step).all(), \
                name
            assert np.mean(new == w) >= 0.9, name
            assert norm_rel(m.float(), mus[name].float()) <= 3e-2, name
