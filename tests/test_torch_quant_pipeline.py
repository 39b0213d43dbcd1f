"""``--quant`` end to end on t2v-tiny: the port's ``WanT2V(quant="w8a8")``
against the JAX ``WanT2V(quant="w8a8")`` from the same quantized weights,
and the port's CLI under each quant mode (``--device cpu``: the int8 GEMM
runs through its plain version)."""

import os

import jax
import numpy as np
import pytest

from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.pipelines import WanT2V as JaxWanT2V
from moviigen_tpu_torch import convert
from moviigen_tpu_torch.cli import generate as cli
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.pipelines.text2video import WanT2V

NOISE = np.random.default_rng(0).standard_normal((4, 2, 8, 8)) \
    .astype(np.float32)


@pytest.fixture(scope="module")
def w8a8_pipes():
    """Both pipelines under ``quant="w8a8"``, the JAX random quantized
    tree (non-zero head) carried into the port's ``QuantLinear``s."""
    jpipe = JaxWanT2V(config=JAX_CONFIGS["t2v-tiny"], checkpoint_dir=None,
                      quant="w8a8")
    tpipe = WanT2V(WAN_CONFIGS["t2v-tiny"], device="cpu", quant="w8a8")

    def tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    convert.load_wan_params(tpipe.dit, tree(jpipe.dit_params))
    convert.load_t5_params(tpipe.t5, tree(jpipe.t5_params))
    tpipe.vae_params = convert.vae_params_to_torch(tree(jpipe.vae_params))
    return jpipe, tpipe


def test_w8a8_latents_match_jax(w8a8_pipes):
    """``--quant w8a8`` end to end: final latents after 3 steps from the
    same quantized weights. Besides the bf16 drift of the unquantized
    case, an upstream difference of one bf16 step can flip a
    ``round(x / sx)`` tie and move an activation code by a whole step
    (1/127 of its token's absmax); over 3 steps of 4 blocks that stays
    within 4e-2 of the latent scale (measured 1.1e-2, against 3e-3
    unquantized), where a wrong scale, layout or bias order is off by
    O(1)."""
    jpipe, tpipe = w8a8_pipes
    assert tpipe.dit.blocks[0].ffn_fc1.act8 and not tpipe._quant_t5
    kw = dict(size=(64, 64), frame_num=5, sampling_steps=3, noise=NOISE,
              return_latents=True)
    want = jpipe.generate("a red fox", **kw)
    got = tpipe.generate("a red fox", **kw)
    assert np.abs(want - NOISE).max() > 0.3  # the sampler moved the latent
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"w8a8 latents: max err {err:.3e} of the latent scale")
    assert err <= 4e-2


@pytest.mark.parametrize("quant", ["int8", "int4", "w8a8"])
def test_cli_quant_writes_a_file(tmp_path, quant):
    out = cli.main(["--task", "t2v-tiny", "--device", "cpu", "--size",
                    "832*480", "--frame_num", "1", "--sample_steps", "1",
                    "--base_seed", "3", "--quant", quant,
                    "--save_file", str(tmp_path / f"{quant}.mp4")])
    assert out is not None and os.path.exists(out)


def test_quant_mode_is_validated():
    with pytest.raises(ValueError, match="int8|int4|w8a8"):
        WanT2V(WAN_CONFIGS["t2v-tiny"], device="cpu", quant="fp8")
