"""Shared fixtures of the benchmark's own tests: a copy of the benchmark
with tiny cells added (``t2v-tiny`` sizes, run on the CPU)."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MODEL = dict(text_len=16, in_dim=4, dim=96, ffn_dim=192, freq_dim=32,
                  text_dim=32, out_dim=4, num_heads=4, num_layers=2)
TINY_T5 = dict(vocab_size=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
               num_layers=2, num_buckets=32, shared_pos=False)


def tiny_config(src: dict) -> dict:
    return dict(src, name="tiny", task="t2v-tiny",
                model=dict(src["model"], **TINY_MODEL), t5=TINY_T5,
                vae=dict(src["vae"], dim=8, z_dim=4))


def make_tiny_root(dst: pathlib.Path, seconds_limits=None) -> pathlib.Path:
    """A copy of BENCHMARK.json and ``benchmark/`` under ``dst`` with three
    tiny cells: ``tiny.serve`` (sequential CFG pair), ``tiny.batched``
    (CFG batched, as ``t2v-tiny`` pairs it) and ``tiny.ft``, each under
    the limits of the cell it shrinks. Only new files are added."""
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst)
    b = json.loads((dst / "BENCHMARK.json").read_text())
    d = dst / "benchmark"
    conf = tiny_config(json.loads((d / "configs/t2v-14B.json").read_text()))
    (d / "configs/tiny.json").write_text(json.dumps(conf))
    ft_conf = dict(tiny_config(json.loads(
        (d / "configs/t2v-1.3B.json").read_text())), name="tiny-ft")
    (d / "configs/tiny-ft.json").write_text(json.dumps(ft_conf))
    serve = json.loads((d / "traffic/480p81.k2.json").read_text())
    (d / "traffic/tiny.serve.json").write_text(json.dumps(dict(
        serve, size=[64, 48], frame_num=9, sampling_steps=3,
        check_latent_frames=2)))
    ft = json.loads((d / "traffic/ft480p81.b1.json").read_text())
    (d / "traffic/tiny.ft.json").write_text(json.dumps(dict(
        ft, items=6, latent_shape=[4, 3, 8, 12], text_tokens=[3, 12])))
    b["configs"] += [
        dict(b["configs"][0], name="tiny", file="benchmark/configs/tiny.json"),
        dict(b["configs"][1], name="tiny-ft",
             file="benchmark/configs/tiny-ft.json")]
    cells = {"tiny.serve": ("tiny", "tiny.serve", "t2v14b.480p81"),
             "tiny.ft": ("tiny-ft", "tiny.ft", "t2v1.3b.ft480p81")}
    for name, (config, traffic, like) in cells.items():
        b["workloads"].append(dict(name=name, config=config, traffic=traffic,
                                   chips=1, why="tiny"))
        shutil.copy(d / f"limits/{like}.json", d / f"limits/{name}.json")
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
