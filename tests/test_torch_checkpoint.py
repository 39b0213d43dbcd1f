"""The port's checkpoint formats against the JAX package and the
``safetensors`` package: the safetensors reader and writer, the DiT
loader and export in the reference layout (both directions through the
JAX converters), and the ``checkpoint-step_N`` save and restore."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.models import wan_convert as jconv
from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.training import checkpoint as jckpt
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.convert import load_wan_params
from moviigen_tpu_torch.models import wan_convert
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.training import TrainConfig, make_optimizer
from moviigen_tpu_torch.training import checkpoint as tckpt
from moviigen_tpu_torch.utils import safetensors as tst

CFG = WAN_CONFIGS["t2v-tiny"].model
JCFG = JAX_CONFIGS["t2v-tiny"].model
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32,
          torch.int64]


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (3, i + 2) if i % 2 else (i + 1,)
        if dt.is_floating_point:
            out[f"t{i}"] = torch.randn(shape, generator=g).to(dt)
        else:
            out[f"t{i}"] = torch.randint(-2**30, 2**30, shape, generator=g,
                                         dtype=dt)
    out["empty"] = torch.zeros((0, 4))
    out["scalar"] = torch.tensor(2.5)
    return out


def _equal(a, b):
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


# ------------------------------------------------------------ safetensors


def test_port_writer_reads_in_the_package(tmp_path):
    want = _tensors()
    path = str(tmp_path / "a.safetensors")
    tst.save_file(want, path)
    _equal(st_load(path), want)


def test_port_reader_reads_the_package(tmp_path):
    want = _tensors(1)
    path = str(tmp_path / "b.safetensors")
    st_save(want, path, metadata={"format": "pt"})  # skipped by the reader
    _equal(tst.load_file(path), want)


def test_reader_refuses_what_it_does_not_take(tmp_path):
    path = str(tmp_path / "c.safetensors")
    st_save({"x": torch.zeros(2, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        tst.load_file(path)
    with pytest.raises(ValueError, match="float64"):
        tst.save_file({"x": torch.zeros(2, dtype=torch.float64)},
                      str(tmp_path / "d.safetensors"))


def test_sharded_dir(tmp_path):
    a, b = {"x": torch.ones(2)}, {"y": torch.zeros(3)}
    tst.save_file(a, str(tmp_path / "m-00001.safetensors"))
    tst.save_file(b, str(tmp_path / "m-00002.safetensors"))
    tst.save_file({"z": torch.ones(1)}, str(tmp_path / "other.safetensors"))
    _equal(tst.load_sharded(str(tmp_path), "m-*.safetensors"), {**a, **b})
    tst.save_file(a, str(tmp_path / "m-00003.safetensors"))
    with pytest.raises(ValueError, match="more than one shard"):
        tst.load_sharded(str(tmp_path), "m-*.safetensors")
    with pytest.raises(FileNotFoundError):
        tst.load_sharded(str(tmp_path), "none-*.safetensors")


# ------------------------------------------------------------ DiT layout


def _random_model(seed=0):
    """A t2v-tiny DiT with every tensor random (a live head included)."""
    model = WanModel(CFG, dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


def _port_params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_port_export_loads_in_jax(tmp_path):
    """Port ``export_wan_safetensors`` → JAX ``load_wan_checkpoint`` (its
    strict key census included) gives the port's parameters."""
    model = _random_model()
    wan_convert.export_wan_safetensors(
        str(tmp_path / wan_convert.EXPORT_NAME), model)
    params = jax.tree_util.tree_map(
        np.asarray, jconv.load_wan_checkpoint(str(tmp_path), JCFG,
                                              dtype=jnp.float32))
    back = load_wan_params(WanModel(CFG, dtype=torch.float32), params)
    _equal(_port_params(back), _port_params(model))


def test_jax_export_loads_in_the_port(tmp_path):
    """The JAX export's state dict → port ``load_wan_checkpoint`` gives
    the JAX parameters; both packages write the same key set.

    JAX ``export_wan_safetensors`` hands ``safetensors.numpy.save_file``
    transposed views, and that writer copies raw memory (it requires
    contiguous arrays), so the file it writes holds every Linear weight
    transposed. The test writes the same dict contiguous, as the export
    means to."""
    from safetensors.numpy import save_file as st_save_np

    params = jax.tree_util.tree_map(
        np.asarray, jwan.init_params(jax.random.PRNGKey(1), JCFG,
                                     jnp.float32))
    sd = jckpt.wan_params_to_state_dict(params, JCFG)
    st_save_np({k: np.ascontiguousarray(v) for k, v in sd.items()},
               str(tmp_path / wan_convert.EXPORT_NAME))
    got = wan_convert.load_wan_checkpoint(str(tmp_path), CFG,
                                          dtype=torch.float32)
    want = load_wan_params(WanModel(CFG, dtype=torch.float32), params)
    _equal(_port_params(got), _port_params(want))
    assert set(tst.load_file(str(tmp_path / wan_convert.EXPORT_NAME))) \
        == wan_convert.expected_wan_keys(CFG) == jconv.expected_wan_keys(JCFG)


def test_state_dict_matches_jax_export_keys_and_values():
    model = _random_model(2)
    params = jax.tree_util.tree_map(
        np.asarray, jconv.convert_wan_state_dict(
            {k: v.numpy() for k, v in
             wan_convert.wan_params_to_state_dict(model).items()},
            JCFG, jnp.float32))
    want = jckpt.wan_params_to_state_dict(params, JCFG)
    got = tckpt.wan_params_to_state_dict(model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_loader_census_is_strict(tmp_path):
    sd = wan_convert.wan_params_to_state_dict(_random_model())
    extra = dict(sd, **{"blocks.0.unknown.weight": torch.zeros(1)})
    tst.save_file(extra, str(tmp_path / wan_convert.EXPORT_NAME))
    with pytest.raises(ValueError, match="not consumed"):
        wan_convert.load_wan_checkpoint(str(tmp_path), CFG)
    wan_convert.load_wan_checkpoint(str(tmp_path), CFG, strict=False)
    sd.pop("head.modulation")
    tst.save_file(sd, str(tmp_path / wan_convert.EXPORT_NAME))
    with pytest.raises(KeyError, match="head.modulation"):
        wan_convert.load_wan_checkpoint(str(tmp_path), CFG)


def test_loader_reads_bf16_shards(tmp_path):
    """Sharded bf16 weights, as the diffusers release stores them: cast to
    the model's dtypes, fp32 islands kept fp32."""
    sd = wan_convert.wan_params_to_state_dict(_random_model(3))
    names = sorted(sd)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        tst.save_file({k: sd[k].to(torch.bfloat16) for k in part},
                      str(tmp_path / f"diffusion_pytorch_model-0000{i}"
                                     "-of-00002.safetensors"))
    model = wan_convert.load_wan_checkpoint(str(tmp_path), CFG)
    assert model.blocks[0].self_attn.q.weight.dtype == torch.bfloat16
    assert model.head.weight.dtype == torch.float32
    back = wan_convert.wan_params_to_state_dict(model)
    for k in names:
        assert torch.equal(back[k], sd[k].to(torch.bfloat16).float()), k


def test_refusals_name_the_remaining_loaders(tmp_path):
    """Every loader is in: a directory without the files raises for the
    first one missing, by name."""
    from moviigen_tpu_torch.cli.generate import main as generate_main
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    with pytest.raises(FileNotFoundError, match="models_t5_umt5-xxl"):
        WanT2V(WAN_CONFIGS["t2v-tiny"], device="cpu",
               checkpoint_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="models_t5_umt5-xxl"):
        generate_main(["--task", "t2v-tiny", "--device", "cpu",
                       "--size", "832*480", "--ckpt_dir", str(tmp_path)])


# ------------------------------------------------------ T5 and VAE layout


def _assert_tree_equals_jax(got, want, path=""):
    """The port's tree against the JAX tree: same nesting; conv ``weight``
    leaves are the JAX ``kernel`` in PyTorch layout."""
    if isinstance(want, dict):
        assert {("weight" if k == "kernel" else k) for k in want} == set(got)
        for k, v in want.items():
            _assert_tree_equals_jax(got["weight" if k == "kernel" else k], v,
                                    f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equals_jax(g, w, f"{path}/{i}")
        return
    w = np.asarray(want)
    if path.endswith("/kernel"):
        w = w.transpose((4, 3, 0, 1, 2) if w.ndim == 5 else (3, 2, 0, 1))
    np.testing.assert_array_equal(got.numpy(), w, err_msg=path)


def test_t5_checkpoint_converters_agree(tmp_path):
    """A random reference-layout encoder state dict (written by the
    port) through both packages' converters gives equal parameters, and
    both refuse a stray key."""
    from moviigen_tpu.models import t5 as jt5
    from moviigen_tpu_torch.convert import t5_params_tree
    from moviigen_tpu_torch.models import t5 as tt5

    cfg, jcfg = WAN_CONFIGS["t2v-tiny"].t5, JAX_CONFIGS["t2v-tiny"].t5
    src = tt5.T5Encoder(cfg, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(0))
    sd = tt5.t5_state_dict(src)
    assert set(sd) == tt5.expected_t5_encoder_keys(cfg) \
        == jt5.expected_t5_encoder_keys(jcfg)
    path = str(tmp_path / "t5.pth")
    torch.save(sd, path)
    want = jt5.load_t5_checkpoint(path, jcfg, dtype=jnp.float32,
                                  as_numpy=True)
    got = tt5.load_t5_checkpoint(path, cfg, dtype=torch.float32)
    tree = t5_params_tree(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tree)))
    assert len(flat_w) == len(flat_g)
    for key, w in flat_w:
        np.testing.assert_array_equal(flat_g[key], w, err_msg=str(key))
    bf16 = tt5.load_t5_checkpoint(path, cfg)  # serving's dtype
    assert bf16.blocks[0].q.weight.dtype == torch.bfloat16
    assert bf16.blocks[0].pos_embedding.dtype == torch.float32

    stray = dict(sd, **{"blocks.0.attn.extra.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="not consumed"):
        tt5.load_t5_state_dict(tt5.T5Encoder(cfg, dtype=torch.float32), stray)
    with pytest.raises(ValueError, match="not consumed"):
        jt5.convert_t5_state_dict({k: v.numpy() for k, v in stray.items()},
                                  jcfg, as_numpy=True)
    del sd["norm.weight"]
    with pytest.raises(KeyError, match="norm.weight"):
        tt5.load_t5_state_dict(tt5.T5Encoder(cfg, dtype=torch.float32), sd)


def test_vae_checkpoint_converters_agree(tmp_path):
    """The same for the VAE, encoder included: the port's random tree
    exported in the reference layout, through both converters."""
    from moviigen_tpu.models import vae_convert as jvc
    from moviigen_tpu_torch.models import vae as tvae
    from moviigen_tpu_torch.models import vae_convert as tvc

    cfg, jcfg = WAN_CONFIGS["t2v-tiny"].vae, JAX_CONFIGS["t2v-tiny"].vae
    src = tvae.init_params(cfg, torch.Generator().manual_seed(0),
                           encoder=True)
    sd = tvc.vae_state_dict(src, cfg)
    assert set(sd) == tvc.expected_vae_keys(cfg) == jvc.expected_vae_keys(jcfg)
    assert sd["decoder.head.0.gamma"].shape == (cfg.dim, 1, 1, 1)
    assert sd["decoder.middle.1.norm.gamma"].dim() == 3
    path = str(tmp_path / "vae.pth")
    torch.save(sd, path)
    want = jax.tree_util.tree_map(
        np.asarray, jvc.load_vae_checkpoint(path, jcfg))
    got = tvc.load_vae_checkpoint(path, cfg)
    _assert_tree_equals_jax(got, want)
    z = torch.randn(1, cfg.z_dim, 2, 4, 4,
                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(tvae.decode(got, z, cfg), tvae.decode(src, z, cfg))

    stray = dict(sd, **{"decoder.extra.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="not consumed"):
        tvc.convert_vae_state_dict(stray, cfg)
    with pytest.raises(ValueError, match="not consumed"):
        jvc.convert_vae_state_dict({k: v.numpy() for k, v in stray.items()},
                                   jcfg)
    del sd["conv2.bias"]
    with pytest.raises(KeyError, match="conv2.bias"):
        tvc.convert_vae_state_dict(sd, cfg)


def test_safetensors_int8_and_metadata(tmp_path):
    """The dtypes of the quantized caches and the header metadata, both
    ways with the ``safetensors`` package."""
    from safetensors import safe_open

    want = {"q8": torch.randint(-127, 128, (5, 3), dtype=torch.int8),
            "q4": torch.randint(0, 256, (4, 2), dtype=torch.uint8)}
    meta = {"source_fingerprint": "x:1:2", "tag": "dit_int8"}
    ours, theirs = str(tmp_path / "a.st"), str(tmp_path / "b.st")
    tst.save_file(want, ours, metadata=meta)
    _equal(st_load(ours), want)
    with safe_open(ours, framework="pt") as f:
        assert f.metadata() == meta
    st_save(want, theirs, metadata=meta)
    _equal(tst.load_file(theirs), want)
    assert tst.read_metadata(theirs) == meta
    tst.save_file(want, ours)
    assert tst.read_metadata(ours) == {}


# ------------------------------------------------------------ checkpoints


def test_save_restore_roundtrip(tmp_path):
    """Parameters, optimizer state and meta come back equal, and the next
    optimizer step after a restore equals the uninterrupted one."""
    tc = TrainConfig(learning_rate=1e-2)
    model = _random_model(4)
    opt = make_optimizer(list(model.parameters()), tc)
    g = torch.Generator().manual_seed(5)
    grads = [[torch.randn(p.shape, generator=g) for p in model.parameters()]
             for _ in range(2)]
    opt.step(grads[0])
    path = tckpt.save_checkpoint(str(tmp_path), 1, model, opt,
                                 extra_meta={"final": False},
                                 export_safetensors=True)
    assert tckpt.latest_checkpoint(str(tmp_path)) == (path, 1)
    assert json.loads(open(f"{path}/meta.json").read()) == \
        {"step": 1, "final": False}
    opt.step(grads[1])

    other = _random_model(6)
    other_opt = make_optimizer(list(other.parameters()), tc)
    assert tckpt.restore_checkpoint(path, other, other_opt) == 1
    assert other_opt.count == 1
    other_opt.step(grads[1])
    _equal(_port_params(other), _port_params(model))
    # the export beside it is the reference layout of the same weights
    exported = wan_convert.load_wan_checkpoint(path, CFG,
                                               dtype=torch.float32)
    restored = _random_model(7)
    tckpt.restore_checkpoint(path, restored)
    _equal(_port_params(exported), _port_params(restored))


def test_restore_refuses_a_different_model(tmp_path):
    path = tckpt.save_checkpoint(str(tmp_path), 3, _random_model())
    bigger = WanModel(CFG.replace(num_layers=3), dtype=torch.float32)
    with pytest.raises(ValueError, match="differ"):
        tckpt.restore_checkpoint(path, bigger)
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_finetune_cli_loads_a_reference_checkpoint(tmp_path):
    """``cli.finetune --ckpt_dir`` trains from the reference-layout
    weights: one step at learning rate 0 leaves them as loaded."""
    from moviigen_tpu_torch.cli.finetune import main

    ds = tmp_path / "ds"
    (ds / "latent").mkdir(parents=True)
    (ds / "prompt_embed").mkdir()
    rng = np.random.default_rng(0)
    np.save(ds / "latent" / "v.npy",
            rng.standard_normal((4, 2, 8, 8)).astype(np.float32))
    np.save(ds / "prompt_embed" / "v.npy",
            rng.standard_normal((5, 32)).astype(np.float32))
    (ds / "videos2caption.json").write_text(json.dumps(
        [{"latent_path": "v.npy", "prompt_embed_path": "v.npy"}]))
    model = _random_model(8)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    wan_convert.export_wan_safetensors(
        str(ckpt / wan_convert.EXPORT_NAME), model)
    out = tmp_path / "out"
    record = main(["--task", "t2v-tiny", "--device", "cpu",
                   "--ckpt_dir", str(ckpt), "--data_json_path",
                   str(ds / "videos2caption.json"), "--num_latent_t", "2",
                   "--output_dir", str(out), "--max_train_steps", "1",
                   "--learning_rate", "0", "--weight_decay", "0",
                   "--export_safetensors"])
    assert record["step"] == 1 and record["grad_norm"][0] > 0
    trained = wan_convert.load_wan_checkpoint(record["checkpoint"], CFG,
                                              dtype=torch.float32)
    _equal(_port_params(trained), _port_params(model))
