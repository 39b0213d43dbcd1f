"""The plain reference against the port at ``t2v-tiny`` sizes on the CPU,
both in float32: each piece the check relies on computes what the
program computes, to float32 rounding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import program
from benchmark.reference import dit as ref_dit
from benchmark.reference import t5 as ref_t5
from benchmark.reference import train as ref_train
from benchmark.reference import unipc as ref_unipc
from benchmark.reference import vae as ref_vae
from benchmark.reference import weights as W
from benchmark.reference.tokenizer import tokenize
from conftest import TINY_MODEL, TINY_T5

SEED = 2 ** 33 + 17
VAE = {"dim": 8, "z_dim": 4, "dim_mult": [1, 2, 4, 4], "num_res_blocks": 2,
       "attn_scales": [], "temporal_downsample": [False, True, True]}


def model_group():
    return dict(TINY_MODEL, model_type="t2v", patch_size=[1, 2, 2],
                window_size=[-1, -1], qk_norm=True, cross_attn_norm=True,
                eps=1e-6)


def port_dit(m, dtype="float32"):
    from moviigen_tpu_torch.configs import WanModelConfig
    from moviigen_tpu_torch.models.wan_model import WanModel

    cfg = WanModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in m.items()})
    model = WanModel(cfg, dtype=getattr(torch, dtype), device="cpu")
    program.load_module(model, "dit", W.dit_specs(m, dtype), W.dit_init(m),
                        SEED)
    return model


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_specs_name_every_leaf_of_the_port():
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.t5 import T5Encoder
    from moviigen_tpu_torch.models.vae import init_params
    from moviigen_tpu_torch.models.wan_model import WanModel

    cfg = WAN_CONFIGS["t2v-14B"]
    m = dict(model_group(), dim=5120, ffn_dim=13824, num_heads=40,
             num_layers=40, text_len=512, in_dim=16, out_dim=16,
             freq_dim=256, text_dim=4096)
    dit = WanModel(cfg.model, device="meta")
    got = {n: (tuple(p.shape), str(p.dtype)[6:])
           for n, p in dit.named_parameters()}
    assert got == {n: (s, d) for n, s, d in W.dit_specs(m)}
    t = dict(TINY_T5, vocab_size=256384, dim=4096, dim_attn=4096,
             dim_ffn=10240, num_heads=64, num_layers=24)
    t5 = T5Encoder(cfg.t5, device="meta")
    assert {n: (tuple(p.shape), str(p.dtype)[6:])
            for n, p in t5.named_parameters()} == \
        {n: (s, d) for n, s, d in W.t5_specs(t)}
    from moviigen_tpu_torch.configs import VAEConfig

    tree = program.flat_tree(init_params(
        VAEConfig(dim=8, z_dim=4), torch.Generator().manual_seed(0)))
    assert {n: tuple(v.shape) for n, v in tree.items()} == \
        {n: s for n, s, _ in W.vae_specs(VAE)}


def test_draws_are_per_group_and_repeat():
    m = model_group()
    specs = W.group_specs("dit", W.dit_specs(m))
    a = W.draw_group(SEED, "dit", "blocks.1", specs["blocks.1"],
                     W.dit_init(m), "cpu")
    b = W.draw_group(SEED, "dit", "blocks.1", specs["blocks.1"],
                     W.dit_init(m), "cpu")
    c = W.draw_group(SEED + 1, "dit", "blocks.1", specs["blocks.1"],
                     W.dit_init(m), "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    assert float(a["blocks.1.ffn_fc1.weight"].float().std()) == \
        pytest.approx((2 / (96 + 192)) ** 0.5, rel=0.1)
    assert a["blocks.1.self_attn.q.weight"].dtype == torch.bfloat16
    assert a["blocks.1.modulation"].dtype == torch.float32


def test_dit_forward_matches_the_port():
    m = model_group()
    model = port_dit(m)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 3, 8, 12, generator=gen)
    t = torch.tensor([999.0, 250.0])
    ctx = torch.randn(2, 16, 32, generator=gen)
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs

    rope = rope_3d_freqs((3, 4, 6), 24)
    with torch.no_grad():
        want = model(x, t, ctx, rope, compute_dtype=torch.float32,
                     attn_backend="plain")
        got = ref_dit.forward(ref_dit.Model(ref_dit.drawn_params(
            SEED, m, "cpu", dtype="float32"), m), x, t, ctx)
    assert float(want.std()) > 0.1  # a live head
    assert rel(got, want) < 2e-5


def test_dit_backward_matches_autograd_of_the_port():
    m = model_group()
    model = port_dit(m)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 4, 3, 8, 12, generator=gen)
    t = torch.tensor([500.0])
    ctx = torch.randn(1, 16, 32, generator=gen)
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs

    out = model(x, t, ctx, rope_3d_freqs((3, 4, 6), 24),
                compute_dtype=torch.float32, attn_backend="plain",
                remat=True)
    grads = torch.autograd.grad(out.square().mean(),
                                list(model.parameters()))
    want = {n: g for (n, _), g in zip(model.named_parameters(), grads)}
    p = {k: v.requires_grad_(True)
         for k, v in ref_train.leaves(SEED, m, "cpu").items()}
    ref_out = ref_dit.forward(ref_dit.Model(lambda g: p, m, remat=True), x, t,
                              ctx)
    names = sorted(p)
    got = torch.autograd.grad(ref_out.square().mean(), [p[k] for k in names])
    for k, g in zip(names, got):
        assert rel(g, want[k]) < 1e-4, k


def test_t5_matches_the_port():
    from moviigen_tpu_torch.configs import T5Config
    from moviigen_tpu_torch.models.t5 import T5Encoder

    t = dict(TINY_T5)
    enc = T5Encoder(T5Config(**t), dtype=torch.float32)
    program.load_module(enc, "t5", W.t5_specs(t, "float32"), W.t5_init(t),
                        SEED)
    ids, mask = tokenize(["a red fox runs", "static, blurry"], 16, 128)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    with torch.no_grad():
        want = enc(ids, mask) * mask[..., None]
        got = ref_t5.encode(ref_t5.drawn_params(SEED, t, "cpu", "float32"),
                            t, ids, mask)
    assert rel(got, want) < 1e-5


def test_tokenizer_matches_the_port():
    from moviigen_tpu_torch.models.tokenizer import HashTokenizer

    texts = ["  A &amp; B\tcinematic  shot ", "色调艳丽，过曝，静态"]
    ids, mask = HashTokenizer(seq_len=16, vocab_size=128)(texts,
                                                          return_mask=True)
    rids, rmask = tokenize(texts, 16, 128)
    assert np.array_equal(ids, rids) and np.array_equal(mask, rmask)


def test_vae_decode_matches_the_port_and_its_stream():
    from moviigen_tpu_torch.configs import VAEConfig
    from moviigen_tpu_torch.models import vae as vaem
    from moviigen_tpu_torch.models.vae_streaming import decode_streaming

    cfg = VAEConfig(dim=8, z_dim=4)
    params = vaem.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = program.flat_tree(params)
    (_, specs), = W.group_specs("vae", W.vae_specs(VAE)).items()
    for k, v in W.draw_group(SEED, "vae", "all", specs, W.vae_init,
                             "cpu").items():
        leaves[k].copy_(v)
    z = torch.randn(1, 4, 5, 6, 8, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = decode_streaming(params, z, cfg, chunk_frames=2)
        dec = ref_vae.Decoder(ref_vae.drawn_params(SEED, VAE, "cpu"))
        got = dec.decode(z[:, :, :3], VAE)
    assert got.shape[2] == 9
    assert float((want[:, :, :9].abs() < 1).float().mean()) > 0.5
    assert rel(got, want[:, :, :9]) < 1e-5


@pytest.mark.parametrize("steps", [1, 2, 3, 10])
def test_unipc_matches_the_port(steps):
    from moviigen_tpu_torch.diffusion import FlowUniPCMultistepScheduler

    s = FlowUniPCMultistepScheduler(num_train_timesteps=1000, shift=1.0)
    s.set_timesteps(steps, shift=5.0)
    r = ref_unipc.UniPC(steps, 5.0)
    assert np.array_equal(s.timesteps, ref_unipc.timesteps(steps, 5.0))
    x0 = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(4))
    x, y, state = x0.clone(), x0.clone(), s.init_state(x0)

    def v(z, i):
        return torch.tanh(z) * 0.7 + 0.1 * i

    for i in range(steps):
        x, state = s.step(v(x, i), i, x, state)
        y = r.step(i, v(y, i), y)
    assert rel(y, x) < 1e-5


def test_train_steps_match_the_port():
    from moviigen_tpu_torch.configs import WanModelConfig
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs
    from moviigen_tpu_torch.training import (TrainConfig, make_optimizer,
                                             make_train_step)

    m = model_group()
    hp = {"learning_rate": 1e-3, "weight_decay": 1e-4, "betas": [0.9, 0.999],
          "eps": 1e-8, "max_grad_norm": 1.0, "num_train_timesteps": 1000}
    cfg = WanModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in m.items()})
    model = WanModel(cfg, dtype=torch.float32)
    program.load_module(model, "dit", W.dit_specs(m, "float32"),
                        W.dit_init(m), SEED)
    tc = TrainConfig(learning_rate=1e-3, remat=True)
    opt = make_optimizer(list(model.parameters()), tc)
    step = make_train_step(model, tc, rope_3d_freqs((3, 4, 6), 24), opt,
                           compute_dtype=torch.float32, attn_backend="plain",
                           generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(5)
    batches = [{"latents": torch.randn(1, 4, 3, 8, 12, generator=gen),
                "context": torch.randn(1, 16, 32, generator=gen)}
               for _ in range(3)]
    names = [n for n, _ in model.named_parameters()]
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(step(b)["loss"]))
        if i == 0:
            g1 = {n: float((mm / 0.1).double().norm())
                  for n, mm in zip(names, opt.m)}
    ref = ref_train.run(SEED, m, hp, batches, 9, "cpu")
    assert np.allclose(losses, ref["loss"], rtol=1e-5)
    keep = ref_train.moved_leaves(ref["grad1"])
    assert len(keep) > len(names) // 2
    gap, _ = ref_train.worst(ref_train.leaf_gaps(g1, ref["grad1"], keep))
    assert gap < 1e-4
    change = {n: float((p.detach() - p0[n]).double().norm())
              for n, p in model.named_parameters()}
    gap, _ = ref_train.worst(ref_train.leaf_gaps(change, ref["change"], keep))
    assert gap < 1e-3
