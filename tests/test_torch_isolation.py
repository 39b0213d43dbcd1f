"""The port stands alone: importing every module of ``moviigen_tpu_torch``
loads neither JAX nor any module of the JAX package, nor a package that
the card's machine lacks (``safetensors``, ``optax``, ``orbax``,
``tensorboard``), and no source of the port (nor ``chip_smoke.py`` and
the across-card tools) imports JAX or the JAX package."""

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "moviigen_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    for mod in ("ops.flash_attention", "utils.safetensors", "models.census",
                "models.wan_convert", "diffusion.flow_match", "training",
                "training.train_step", "training.data",
                "training.checkpoint", "cli.finetune", "ops.quantization",
                "ops.int8_gemm", "models.vae_convert", "data",
                "data.video_reader", "data.transforms", "data.t2v_dataset",
                "cli.preprocess", "cli.preprocess_stages",
                "cli.video_tools", "training.lora", "training.ot",
                "cli.valid_training", "models.clip", "ops.resize",
                "pipelines.image2video", "utils.profiling", "utils.metrics",
                "native", "native.loader", "utils.prompt_extend",
                "utils.qwen_vl", "apps.gradio_t2v"):
        assert f"moviigen_tpu_torch.{mod}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m == 'moviigen_tpu' or m.startswith('moviigen_tpu.')\n"
        "             or m.split('.')[0] in ('safetensors', 'optax', 'orbax',\n"
        "                                    'tensorboard'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_no_jax_package():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|moviigen_tpu)\b(?!_torch)"
        r"|from\s+(jax|jaxlib|moviigen_tpu)(\.|\s)(?!_torch))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "tools" / name for name in ("cards.py", "sp_serve_cards.py",
                                           "sp_train_cards.py")]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []
    # the scan itself catches what it must
    assert pattern.search("import jax.numpy as jnp")
    assert pattern.search("from moviigen_tpu.ops import norms")
    assert not pattern.search("from moviigen_tpu_torch.ops import norms")
