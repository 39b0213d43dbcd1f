"""A pipeline is freed by reference counting alone: with the cyclic
collector off, an object whose ``__init__`` falls back to the hash
tokenizer (no tokenizer assets) is freed at ``del``, and ``cli.generate``
leaves no pipeline alive when it returns.

Two reference cycles kept a whole pipeline allocated after
``cli.generate`` returned, until ``gc.collect()``: the frames that
``load_tokenizer``'s failed first attempt (the first import of
``transformers`` in a process) leaves in cycles, whose ``f_back`` chain
reached the pipeline's ``__init__``; and ``cache_video`` keeping a failed
writer's exception, whose traceback held its frame and so the caller's.
The cases run in one fresh process, the pipeline first: only the first
attempt of a process imports ``transformers``, as ``cli.generate``'s
pipeline makes it.
"""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import gc
import json
import os
import tempfile
import weakref

from moviigen_tpu_torch.models.tokenizer import HashTokenizer, load_tokenizer


class Holder:
    def __init__(self):
        self.tokenizer = load_tokenizer("nope", 8)


def t2v_tiny():
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    return WanT2V(WAN_CONFIGS["t2v-tiny"], device="cpu")


def cli_generate_leaves_none():
    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    out = os.path.join(tempfile.mkdtemp(), "video.mp4")
    assert generate.main(["--task", "t2v-tiny", "--device", "cpu",
                          "--size", "832*480", "--frame_num", "1",
                          "--sample_steps", "1", "--save_file", out])
    return not [o for o in gc.get_objects() if isinstance(o, WanT2V)]


dead = {}
for name, build in (("t2v_tiny", t2v_tiny), ("holder", Holder)):
    gc.collect()
    gc.disable()
    try:
        obj = build()
        assert isinstance(obj.tokenizer, HashTokenizer), type(obj.tokenizer)
        ref = weakref.ref(obj)
        del obj
        dead[name] = ref() is None
    finally:
        gc.enable()
gc.collect()
gc.disable()
try:
    dead["cli_generate"] = cli_generate_leaves_none()
finally:
    gc.enable()
print(json.dumps(dead))
"""


@pytest.fixture(scope="module")
def dead_at_del():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("what", ["t2v_tiny", "holder", "cli_generate"])
def test_pipeline_is_freed_by_refcounting(dead_at_del, what):
    assert dead_at_del[what]
