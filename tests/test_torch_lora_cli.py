"""The port's LoRA files and entry points against the JAX package on
t2v-tiny: the peft-layout export, ``cli.finetune --use_lora`` (and
``--quant``) and the validation watcher ``cli.valid_training``.
Adapters and bases come from tests/test_torch_lora.py's helpers."""

import json
import sys

import numpy as np
import pytest
import torch

from moviigen_tpu.training import checkpoint as jckpt
from moviigen_tpu_torch.convert import lora_params_to_torch
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.training import checkpoint as tckpt
from moviigen_tpu_torch.training import lora as tlora
from moviigen_tpu_torch.utils.safetensors import load_file

from test_torch_lora import ALPHA, CFG, RANK, base_pair, jax_adapters
from test_torch_training import tiny_dataset  # noqa: F401


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The fine-tune CLI logs to TensorBoard when it is installed, whose
    import pulls in TensorFlow where that is installed (seconds a process);
    no test of this file reads those logs (tests/test_torch_training.py
    runs the CLI with them). The watcher's pipelines take the hash
    tokenizer without first trying ``transformers`` (the tests have no
    tokenizer assets, so it is the same tokenizer; that import pulls in
    TensorFlow as well)."""
    from moviigen_tpu_torch.models import tokenizer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(tokenizer, "_huggingface_or_none",
                        lambda **kwargs: None)


# ------------------------------------------------------------ peft export

def _safetensors_numpy(path):
    from safetensors.numpy import load_file as st_load

    return st_load(path)


def test_peft_export_equals_jax_and_round_trips(tmp_path):
    """The same adapters exported by both packages: the same keys, the
    tensors of the JAX ``lora_to_peft_state_dict`` bit for bit (fp32,
    [r, d_in] / [d_out, r], unscaled) and the same
    ``adapter_config.json``; the JAX loader reads the port's file back to
    the adapters, and the port's loader the JAX state dict.

    The JAX file itself is written scrambled: its ``lora_{A,B}.weight``
    are transposed numpy views, and safetensors 0.8.0 stores their memory
    order, so each holds A's (B's) bytes in A's own order under the
    transposed shape (ROADMAP §3). The port writes contiguous tensors."""
    tree, _ = base_pair(None)
    lora = jax_adapters(tree)
    adapters = lora_params_to_torch(lora)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jpath = str(tmp_path / "jax" / tckpt.LORA_EXPORT_NAME)
    tpath = str(tmp_path / "port" / tckpt.LORA_EXPORT_NAME)
    jckpt.export_lora_safetensors(jpath, lora, alpha=ALPHA, rank=RANK)
    tckpt.export_lora_safetensors(tpath, adapters, alpha=ALPHA, rank=RANK)
    jfile, tsd = _safetensors_numpy(jpath), _safetensors_numpy(tpath)
    jsd = jckpt.lora_to_peft_state_dict(lora)
    assert set(jsd) == set(tsd) == set(jfile)
    assert tsd["blocks.1.cross_attn.o.lora_A.weight"].shape == (RANK,
                                                                CFG.dim)
    for k in jsd:
        assert tsd[k].dtype == np.float32
        np.testing.assert_array_equal(tsd[k], jsd[k], err_msg=k)
        # the JAX file's fault, pinned: memory order, transposed shape
        assert jfile[k].shape == jsd[k].shape
        np.testing.assert_array_equal(jfile[k].ravel(), jsd[k].T.ravel())
    jcfg = json.loads((tmp_path / "jax" / tckpt.ADAPTER_CONFIG).read_text())
    tcfg = json.loads((tmp_path / "port" / tckpt.ADAPTER_CONFIG).read_text())
    assert tcfg == jcfg and tcfg["target_modules"][0] == "cross_attn/k"

    for sd in (load_file(tpath),
               {k: torch.from_numpy(v.copy()) for k, v in jsd.items()}):
        back = tckpt.lora_from_peft_state_dict(sd)
        assert set(back) == set(adapters)
        for path, ad in adapters.items():
            assert torch.equal(back[path].A, ad.A) and torch.equal(
                back[path].B, ad.B), path
    jback = jckpt.lora_from_peft_state_dict(tsd)
    for base, ab in lora.items():
        for k in ("A", "B"):
            np.testing.assert_array_equal(jback[base][k], ab[k])


def test_peft_loader_raises_on_prefixed_keys():
    """A peft file saved from a wrapped model carries a prefix
    (``base_model.model.``): the JAX loader's anchored pattern skips
    every key and returns nothing; the port's raises."""
    tree, _ = base_pair(None)
    sd = tckpt.lora_to_peft_state_dict(
        lora_params_to_torch(jax_adapters(tree)))
    prefixed = {f"base_model.model.{k}": v for k, v in sd.items()}
    assert jckpt.lora_from_peft_state_dict(
        {k: v.numpy() for k, v in prefixed.items()}) == {}
    with pytest.raises(ValueError, match="no prefix"):
        tckpt.lora_from_peft_state_dict(prefixed)
    with pytest.raises(ValueError, match="lora_A and lora_B"):
        tckpt.lora_from_peft_state_dict(
            {k: v for k, v in sd.items() if "lora_B" not in k})


# ------------------------------------------------------------ CLIs


def _finetune(dataset, out, *extra, steps=2):
    from moviigen_tpu_torch.cli.finetune import main

    return main(["--task", "t2v-tiny", "--device", "cpu",
                 "--data_json_path", dataset, "--num_latent_t", "2",
                 "--output_dir", str(out), "--max_train_steps", str(steps),
                 "--checkpointing_steps", "100", "--learning_rate", "1e-2",
                 "--gradient_checkpointing", "--lora_rank", str(RANK),
                 *extra])


@pytest.mark.parametrize("quant", [None, "int8"])
def test_finetune_cli_lora(tiny_dataset, tmp_path, quant):
    """``--use_lora`` (and QLoRA ``--quant int8``) for 2 steps: only the
    adapters train and are saved, the base stays as it was built from
    the seed, the peft export reads back to the adapters, meta.json
    carries what the watcher needs; then resume to step 4. The random
    head is zero, so the loss reaches no adapter (grad_norm 0, as in
    JAX) and only weight decay moves A (by lr·wd = 1e-6 of itself a
    step): the adapters' own draw from seed + 1 is what is checked."""
    out = tmp_path / "out"
    extra = ["--use_lora", "--export_safetensors"] + (
        ["--quant", quant] if quant else [])
    rec = _finetune(tiny_dataset, out, *extra)
    assert rec["step"] == 2 and np.isfinite(rec["loss"]).all()
    model, adapters = rec["model"], rec["adapters"]
    assert len(adapters) == 8 * CFG.num_layers
    assert all(not p.requires_grad for n, p in model.named_parameters()
               if ".lora." not in n)
    fresh = WanModel(CFG, dtype=torch.float32, quant=quant).init_weights(
        torch.Generator().manual_seed(42))
    for k, v in fresh.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    tmpl = tlora.init_lora_params(
        fresh, rank=RANK, generator=torch.Generator().manual_seed(43))
    for path, ad in adapters.items():
        torch.testing.assert_close(ad.A, tmpl[path].A, rtol=1e-5, atol=0)
        assert not ad.B.any(), path
    ckpt = out / "checkpoint-step_2"
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta == {"step": 2, "final": True, "lora": True,
                    "quant": quant or "none", "lora_rank": RANK,
                    "lora_alpha": 64, "lora_dtype": "float32"}
    saved = load_file(str(ckpt / tckpt.PARAMS_FILE))
    assert set(saved) == set(tlora.lora_state_dict(adapters))
    assert not (ckpt / "diffusion_pytorch_model.safetensors").exists()
    peft = tckpt.lora_from_peft_state_dict(
        load_file(str(ckpt / tckpt.LORA_EXPORT_NAME)))
    assert all(torch.equal(peft[p].A, ad.A) for p, ad in adapters.items())
    cfg = json.loads((ckpt / tckpt.ADAPTER_CONFIG).read_text())
    assert cfg["r"] == RANK and cfg["lora_alpha"] == 64

    rec = _finetune(tiny_dataset, out, *extra, "--resume_from_checkpoint",
                    "latest", steps=4)
    assert rec["step"] == 4 and len(rec["loss"]) == 2
    assert rec["optimizer"].count == 4


def test_finetune_cli_lora_trains_with_a_live_head(tiny_dataset, tmp_path,
                                                   monkeypatch):
    """With a live head the adapters get gradients: after one step only B
    has moved (dA = xᵀ·dout·Bᵀ is zero while B = 0; weight decay moves A
    by lr·wd = 1e-6 of itself), after two both have by about lr = 1e-2
    (AdamW's first steps move each element by ~lr). ``--gradient_
    accumulation_steps`` keeps its accumulator over the adapters alone."""
    init = WanModel.init_weights

    def live_head(self, generator):
        init(self, generator)
        with torch.no_grad():
            self.head.weight.normal_(0.0, 0.1, generator=generator)
        return self

    monkeypatch.setattr(WanModel, "init_weights", live_head)
    start = tlora.init_lora_params(
        WanModel(CFG, dtype=torch.float32), rank=RANK,
        generator=torch.Generator().manual_seed(43))
    for steps, a_moves in ((1, False), (2, True)):
        rec = _finetune(tiny_dataset, tmp_path / f"o{steps}", "--use_lora",
                        "--quant", "int4", steps=steps)
        assert min(rec["grad_norm"]) > 0
        for path, ad in rec["adapters"].items():
            assert bool(ad.B.abs().max() > 0), path
            moved = float((ad.A.detach() - start[path].A).abs().max())
            assert (moved > 1e-3) if a_moves else (moved < 1e-5), path
    rec = _finetune(tiny_dataset, tmp_path / "acc", "--use_lora",
                    "--gradient_accumulation_steps", "2", steps=2)
    opt = rec["optimizer"]
    assert opt.count == 1 and len(opt.acc) == 2 * len(rec["adapters"])


def test_finetune_cli_quant_needs_lora(tiny_dataset):
    """``--quant`` without ``--use_lora`` exits, as the JAX CLI does."""
    from moviigen_tpu_torch.cli.finetune import main

    with pytest.raises(SystemExit, match="--quant requires --use_lora"):
        main(["--task", "t2v-tiny", "--device", "cpu", "--data_json_path",
              tiny_dataset, "--quant", "int8"])


def test_valid_training_adapters_and_full_checkpoints(tiny_dataset,
                                                      tmp_path):
    """``cli.valid_training --once`` over an adapter-only checkpoint (the
    adapters restored into a template from the base and attached) and
    over a full one (restored into the pristine base); then one watcher
    taking adapter, full, adapter checkpoints in turn: the full one comes
    without the earlier adapters, and the later adapters are attached to
    the base again, not to the fine-tuned weights."""
    from moviigen_tpu_torch.cli import valid_training as vt

    prompts = tmp_path / "prompts"
    prompts.mkdir()
    (prompts / "p0.txt").write_text("a tiny test video")
    lora_out, full_out = tmp_path / "lora", tmp_path / "full"
    _finetune(tiny_dataset, lora_out, "--use_lora", "--lora_alpha", "8",
              "--quant", "int8", steps=1)
    _finetune(tiny_dataset, full_out, steps=1)
    # live adapters, so that attaching them is seen
    path = lora_out / "checkpoint-step_1" / tckpt.PARAMS_FILE
    sd = {k: v + 0.05 for k, v in load_file(str(path)).items()}
    from moviigen_tpu_torch.utils.safetensors import save_file

    save_file(sd, str(path))

    argv = ["--task", "t2v-tiny", "--device", "cpu", "--once",
            "--prompt_dir", str(prompts), "--size", "832*480",
            "--frame_num", "1", "--sample_steps", "1"]
    for out, lora in ((lora_out, True), (full_out, False)):
        rec = vt.main(argv + ["--output_dir", str(out)])
        (render,) = rec["renders"]
        assert render["lora"] is lora and render["step"] == 1
        video = render["videos"]["p0"]
        assert video.shape == (3, 1, 480, 832) and np.isfinite(video).all()
        assert np.abs(video).max() <= 1.0
        assert (out / "checkpoint-step_1" / "validation_videos"
                / "p0_step1.mp4").exists()
        dit = rec["pipe"].dit
        mounted = [n for n, _ in dit.named_parameters() if ".lora." in n]
        assert len(mounted) == (2 * 8 * CFG.num_layers if lora else 0)

    args = vt._parse_args(argv + ["--output_dir", str(lora_out)])
    w = vt._Watcher(vt.WAN_CONFIGS["t2v-tiny"], args)
    base = {n: p.detach().clone() for n, p in w.pipe.dit.named_parameters()}
    w.load(str(lora_out / "checkpoint-step_1"))
    attached = tlora.lora_state_dict(w.pipe.detach_lora())
    for k, v in sd.items():
        assert torch.equal(attached[k].detach(), v), k
    w.load(str(lora_out / "checkpoint-step_1"))
    w.load(str(full_out / "checkpoint-step_1"))
    full = load_file(str(full_out / "checkpoint-step_1" / tckpt.PARAMS_FILE))
    params = dict(w.pipe.dit.named_parameters())
    assert set(params) == set(full)
    assert all(torch.equal(params[k], full[k].to(params[k].dtype))
               for k in full)
    w.load(str(lora_out / "checkpoint-step_1"))
    for n, p in w.pipe.dit.named_parameters():
        if ".lora." not in n:
            assert torch.equal(p, base[n]), n


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_qlora_base_quantized_as_it_loads(tiny_dataset, tmp_path, quant):
    """``--ckpt_dir`` with ``--quant``: ``load_wan_checkpoint(quant=...)``
    quantizes each block linear as it loads, bit-equal to loading the
    fp32 model and quantizing it (``quantize_wan_params``, held to JAX's
    codes by test_torch_quantization.py); the CLI trains adapters over
    that base."""
    from moviigen_tpu_torch.models.wan_convert import (EXPORT_NAME,
                                                       export_wan_safetensors,
                                                       load_wan_checkpoint)
    from moviigen_tpu_torch.ops.quantization import quantize_wan_params

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    src = WanModel(CFG, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(5))
    with torch.no_grad():
        for blk in src.blocks:  # non-zero biases, so that they are seen
            blk.self_attn.q.bias.normal_(generator=torch.Generator()
                                         .manual_seed(6))
    export_wan_safetensors(str(ckpt / EXPORT_NAME), src)
    got = load_wan_checkpoint(str(ckpt), CFG, torch.float32, quant=quant)
    want = quantize_wan_params(load_wan_checkpoint(str(ckpt), CFG,
                                                   torch.float32),
                               bits=4 if quant == "int4" else 8)
    assert set(got.state_dict()) == set(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    rec = _finetune(tiny_dataset, tmp_path / "out", "--use_lora", "--quant",
                    quant, "--ckpt_dir", str(ckpt), steps=1)
    for k, v in want.state_dict().items():
        assert torch.equal(rec["model"].state_dict()[k], v), k
