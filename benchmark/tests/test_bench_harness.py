"""The harness on the CPU: what it may import, what it finds by name, its
counters and interval arithmetic, the names ``BENCHMARK.json`` may hold,
and that no run falls back to the CPU."""

from __future__ import annotations

import ast
import hashlib
import json
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

from benchmark import core, counters, tracing
from conftest import REPO, make_tiny_root

BENCH = REPO / "benchmark"


def _py(code: str, cwd=REPO, env=None, timeout=600):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    """Every import statement under benchmark/, by top-level name as a
    whole (``moviigen_tpu_torch`` starts with ``moviigen_tpu``)."""
    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert _top(n) not in core.FORBIDDEN, (path, n)
                if "reference" in path.parts:
                    assert _top(n) != "moviigen_tpu_torch", (path, n)


def test_runs_load_neither_jax_nor_the_jax_package(tmp_path):
    """A whole tiny serving and fine-tune run in a fresh interpreter, and
    then every module it loaded by top-level name."""
    root = make_tiny_root(tmp_path)
    out = _py(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        from benchmark import core, serve, finetune, control, tracing
        from benchmark import run as bench_run
        bench = core.Bench({str(root)!r})
        for name, mod in (("tiny.serve", serve), ("tiny.ft", finetune)):
            res = mod.run(bench, bench.cell(name), 3, 0.01, True, "cpu")
            for m in bench.metrics(name, True):
                bench.reader(m["name"])(res["ctx"])
        print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
    """, env={"PYTHONHASHSEED": "0", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "moviigen_tpu_torch" in loaded
    assert not loaded & set(core.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    out = _py(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from benchmark.reference import dit, t5, tokenizer, train, unipc, vae, weights
        m = dict(patch_size=[1, 2, 2], text_len=4, in_dim=4, dim=16,
                 ffn_dim=32, freq_dim=8, text_dim=8, out_dim=4, num_heads=2,
                 num_layers=1, qk_norm=True, cross_attn_norm=True, eps=1e-6)
        ctx = dit.Model(dit.drawn_params(1, m, "cpu"), m)
        dit.forward(ctx, torch.zeros(1, 4, 1, 2, 2), torch.ones(1),
                    torch.zeros(1, 4, 8))
        print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"moviigen_tpu_torch", *core.FORBIDDEN}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "moviigen_tpu_torch_extra", object())
    assert "moviigen_tpu_torch_extra" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert core.forbidden_modules() == ["jax.numpy"]


def _digests(root: pathlib.Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_come_from_new_files_alone(tmp_path):
    root = make_tiny_root(tmp_path)
    d = root / "benchmark"
    (d / "metrics" / "requests.serve.py").write_text(textwrap.dedent("""
        def read(ctx):
            return ctx.get("requests")
    """))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "requests.serve", "unit": "1",
                           "better": "higher", "source": "host_clock",
                           "layer": "pipeline", "moves": "denoise_step_s",
                           "workloads": ["tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    before = {k: v for k, v in _digests(REPO).items()}
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    bench = core.Bench(root)
    cell = bench.cell("tiny.serve")
    assert bench.config(cell["config"])["task"] == "t2v-tiny"
    assert bench.traffic(cell["traffic"])["size"] == [64, 48]
    assert set(bench.limits("tiny.serve")) == {"text_rel", "latent_rel",
                                              "video_rel"}
    names = [m["name"] for m in bench.metrics("tiny.serve", True)]
    assert "requests.serve" in names and "mfu.serve" in names
    assert "mfu.train" not in names
    assert bench.reader("requests.serve")({"requests": 3}) == 3
    res = {"correct": True, "attempted": 1, "failed": 0, "ctx": {
        "kind": "serve", "requests": 3, "t5_s": [0.5], "steps": 2,
        "window_s": 1.0, "flops": 1.0, "trace": None},
        "checks": {"latent_rel": (0.1, 0.2)}, "window": None}
    readers = {n: bench.reader(n) for n in names}
    line = core.result_line(res, bench.metrics("tiny.serve", True), readers,
                            True, {"platform": "gpu"})
    assert line["metrics"]["requests.serve"] == {"value": 3, "unit": "1"}
    assert line["metrics"]["t5_ms.serve"]["value"] == 500.0
    assert "mfu.serve" not in line["metrics"]  # no card: nothing to read
    assert list(line)[-1] == "checks"


def test_dit_flops_by_hand_at_the_cells_shapes():
    conf = json.loads((BENCH / "configs/t2v-14B.json").read_text())["model"]
    # per block at L = 32,760, d = 5,120, f = 13,824, Lt = 512:
    per_block = (10_305_404_928_000      # 12·L·d², q k v o
                 + 21_979_496_448_000    # 4·L²·d, self-attention products
                 + 53_687_091_200        # 4·Lt·d², cross k v
                 + 343_513_497_600       # 4·L·Lt·d, cross products
                 + 9_274_864_435_200)    # 4·L·d·f, FFN
    assert counters.dit_flops(conf, 32760, batch=2) == 2 * 40 * per_block
    ft = json.loads((BENCH / "configs/t2v-1.3B.json").read_text())["model"]
    # d = 1,536, f = 8,960, 30 blocks
    per_block = (12 * 32760 * 1536 ** 2 + 4 * 32760 ** 2 * 1536
                 + 4 * 512 * 1536 ** 2 + 4 * 32760 * 512 * 1536
                 + 4 * 32760 * 1536 * 8960)
    assert per_block == 9_432_667_127_808
    assert counters.dit_flops(ft, 32760) == 30 * per_block


def test_attention_work_by_hand():
    conf = json.loads((BENCH / "configs/t2v-14B.json").read_text())["model"]
    ops, nbytes = counters.attention_work(conf, 7800, batch=2)
    # forward: 4·Lq·Lk·d over self (7,800²) and cross (7,800 × 512), 40
    # blocks, 2 samples
    assert ops == 2 * 40 * 4 * 5120 * (7800 * 7800 + 7800 * 512)
    # q, k, v read and o written once, bf16
    assert nbytes == 2 * 40 * 2 * 5120 * ((2 * 7800 + 2 * 7800)
                                          + (2 * 7800 + 2 * 512))
    ops_b, bytes_b = counters.attention_work(conf, 7800, backward=True)
    assert ops_b == 3 * ops / 2  # the backward's four products on top
    assert bytes_b == nbytes / 2 + 40 * 2 * 5120 * (
        (5 * 7800 + 3 * 7800) + (5 * 7800 + 3 * 512))
    assert counters.tokens_of(conf, [16, 21, 60, 104]) == 32760


class _Ev:
    def __init__(self, name, start, dur, cuda, thread=1):
        from torch.autograd import DeviceType

        self._n, self._s, self._d, self._t = name, start, dur, thread
        self._dev = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return False


def test_interval_arithmetic():
    assert tracing.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert tracing.length([(0, 3), (5, 8)]) == 6
    assert tracing.gaps([(2, 3), (5, 8)], 0, 10) == [(0, 2), (3, 5), (8, 10)]
    host = [(0, 100, "outer"), (10, 20, "a"), (30, 60, "b"), (40, 50, "c")]
    assert tracing.innermost(host, [5, 15, 35, 45, 55, 70, 200]) == [
        "outer", "a", "b", "c", "b", "outer", None]


def test_window_from_events():
    evs = [_Ev("bench.window", 100, 1000, False),
           _Ev("bench.request", 110, 980, False),
           _Ev("cudaStreamSynchronize", 600, 300, False),
           _Ev("bench.window", 100, 1000, True),      # a range, not work
           _Ev("flash_fwd_kernel<Variant)1>", 150, 300, True),
           _Ev("sm90_xmma_gemm_bf16", 400, 100, True),
           _Ev("vectorized_elementwise_kernel", 450, 100, True),  # overlaps
           _Ev("elementwise_kernel", 50, 100, True),  # half before the window
           _Ev("aten::copy_", 2000, 5, True)]         # after it
    w = tracing.Window(evs, tracing.Categories())
    assert w.window_s == 1000e-9
    # device busy in [100, 150) ∪ [150, 550) = 450 ns
    assert w.busy_s == pytest.approx(450e-9)
    assert w.category_s == pytest.approx({"attention": 300e-9,
                                          "gemm": 100e-9,
                                          "elementwise": 150e-9})
    # idle [550, 1100): the host was in bench.request until 600, then in
    # the synchronise until 900, then in bench.request again
    assert dict(w.idle_gaps) == pytest.approx({"bench.request": 550e-9})
    assert w.breakdown()["device_ops"][0][0].startswith("flash_fwd")


def test_window_from_the_tracers_marks():
    """On the card only CUDA activity is traced: the window runs from the
    end of the tracer's first synchronise to the start of its last, and
    idle gaps are named by the CUDA call the host was in."""
    evs = [_Ev(tracing.MARK, 50, 50, False),
           _Ev("cudaLaunchKernel", 120, 10, False),
           _Ev("cudaStreamSynchronize", 600, 300, False),
           _Ev("cudaLaunchKernel", 950, 10, False, thread=2),  # a helper
           _Ev(tracing.MARK, 1100, 20, False),
           _Ev("flash_fwd_kernel", 130, 370, True),
           _Ev("elementwise_kernel", 910, 40, True)]
    w = tracing.Window(evs, tracing.Categories())
    assert w.marked_by == tracing.MARK
    assert w.window_s == pytest.approx(1000e-9)
    assert w.busy_s == pytest.approx(410e-9)
    # idle [100, 130) as the host leaves the first mark, [500, 910) the
    # host outside any call until the synchronise at 600, [950, 1100)
    # outside any call of this thread
    assert dict(w.idle_gaps) == pytest.approx({
        tracing.MARK: 30e-9, tracing.NO_RANGE: 560e-9})
    with pytest.raises(RuntimeError, match="no bench.window range"):
        tracing.Window(evs[1:], tracing.Categories())  # one mark only


def test_a_traffic_file_finds_its_driver_by_name(tmp_path):
    root = make_tiny_root(tmp_path)
    d = root / "benchmark"
    t = json.loads((d / "traffic/tiny.serve.json").read_text())
    (d / "traffic/tiny.other.json").write_text(
        json.dumps(dict(t, driver="other")))
    bench = core.Bench(root)
    with pytest.raises(ValueError, match="no driver"):
        bench.traffic("tiny.other")
    (d / "other.py").write_text("def run(*a, **kw):\n    return {}\n")
    assert bench.traffic("tiny.other")["driver"] == "other"
    (d / "traffic/tiny.bad.json").write_text(
        json.dumps(dict(t, driver="../run")))
    with pytest.raises(ValueError, match="no driver"):
        bench.traffic("tiny.bad")


def test_categories_follow_the_copied_table():
    cat = tracing.Categories()
    assert cat("void flash_bwd_dkv_kernel<128>") == "attention"
    assert cat("int8_gemm_kernel") == "int8_gemm"
    assert cat("nvjet_tst_128x256") == "gemm"
    assert cat("cudnn::conv3d_fprop") == "conv"
    assert cat("Memcpy DtoD (Device -> Device)") == "elementwise"
    assert cat("ncclDevKernel_AllGather") == "nccl"


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(b)) < 64 * 1024
    assert 1 <= b["run_seconds"] <= 51
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert len(c["why"]) <= 200 and "\n" not in c["why"]
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        cells.add(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", ())) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", ()):
            assert any(e["name"] == m["moves"] and cell in e.get(
                "workloads", cells) for e in b["end_to_end"])
    for cell in cells:
        assert any(cell in m.get("workloads", cells)
                   for m in b["per_layer"])


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "t2v14b.480p81",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # and in a directory that holds the benchmark alone: no program
    alone = tmp_path / "alone"
    alone.mkdir()
    make_tiny_root(alone)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "t2v14b.480p81",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=alone, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_launch_runs_one_process_per_rank(tmp_path):
    from benchmark import launch

    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent("""
        import os, sys
        assert sys.argv[1] == "--worker"
        print("rank", os.environ["RANK"], "of", os.environ["WORLD_SIZE"],
              "hash seed", os.environ["PYTHONHASHSEED"], sys.argv[2])
    """))
    log = tmp_path / "launch.log"
    launch.launch(worker, ["x"], 2, log, timeout=120)
    text = log.read_text()
    assert "rank 0 of 2 hash seed 0 x" in text
    assert "rank 1 of 2 hash seed 0 x" in text
    bad = tmp_path / "bad.py"
    bad.write_text("raise SystemExit(3)\n")
    with pytest.raises(SystemExit):
        launch.launch(bad, [], 1, tmp_path / "bad.log", timeout=120)
