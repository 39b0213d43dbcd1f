"""The port's apps and prompt extension against the JAX package's: the
gradio app (``apps/gradio_t2v.py``) with the UI toolkit stubbed as
tests/test_gradio_app.py does, ``utils/prompt_extend.py`` (system prompts,
dispatch, the offline and DashScope paths), ``utils/qwen_vl.py`` over the
cases of tests/test_qwen_vl.py, and ``cli.generate --use_prompt_extend``.

The tests have no rewriter weights and may download nothing: a stub
``transformers`` whose loaders raise as an offline hub does stands in for
the real one (whose import alone takes seconds), and a stub ``dashscope``
for the SDK. The requests run at 64×64 (a size added to the
size table for these tests) with the hash tokenizer."""

import base64
import io as _io
import logging
import sys
import types

import numpy as np
import pytest
import torch

from moviigen_tpu.utils import prompt_extend as jpe
from moviigen_tpu.utils import qwen_vl as jqv
from moviigen_tpu_torch import configs
from moviigen_tpu_torch.apps import gradio_t2v
from moviigen_tpu_torch.cli import generate as cli
from moviigen_tpu_torch.models import tokenizer
from moviigen_tpu_torch.pipelines.text2video import WanT2V
from moviigen_tpu_torch.utils import prompt_extend as tpe
from moviigen_tpu_torch.utils import qwen_vl as tqv


class _Component:
    def __init__(self, *a, **k):
        self.label = k.get("label")
        self.value = k.get("value")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Clickable(_Component):
    registry = []

    def click(self, fn, inputs=None, outputs=None):
        _Clickable.registry.append(
            {"fn": fn, "inputs": inputs, "outputs": outputs})


def _gradio_stub():
    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Row", "Column", "Textbox", "Radio",
                 "Dropdown", "Slider", "Number", "Video", "Markdown"):
        setattr(gr, name, type(name, (_Component,), {}))
    gr.Button = type("Button", (_Clickable,), {})
    return gr


def _offline_transformers():
    """``transformers`` as an offline hub without the weights leaves it:
    every loader raises OSError."""
    tf = types.ModuleType("transformers")

    class _Auto:
        @classmethod
        def from_pretrained(cls, name, **kwargs):
            raise OSError(f"{name} is not in the local cache (offline)")

    for name in ("AutoTokenizer", "AutoModelForCausalLM", "AutoProcessor",
                 "AutoModelForVision2Seq"):
        setattr(tf, name, type(name, (_Auto,), {}))
    return tf


@pytest.fixture
def env(monkeypatch, tmp_path):
    """The stubs, the hash tokenizer, a 64×64 size, a scratch cwd."""
    _Clickable.registry = []
    monkeypatch.setitem(sys.modules, "gradio", _gradio_stub())
    monkeypatch.setitem(sys.modules, "transformers", _offline_transformers())
    monkeypatch.setitem(sys.modules, "dashscope", None)  # not installed
    monkeypatch.setattr(tokenizer, "_huggingface_or_none",
                        lambda **kwargs: None)
    monkeypatch.setitem(configs.SIZE_CONFIGS, "64*64", (64, 64))
    monkeypatch.setitem(configs.SUPPORTED_SIZES, "t2v-tiny",
                        (*configs.SUPPORTED_SIZES["t2v-tiny"], "64*64"))
    monkeypatch.chdir(tmp_path)  # the app writes example.mp4 to the cwd
    return _Clickable.registry


def _capture(monkeypatch, module):
    videos = []
    keep = module.cache_video

    def capture(video, save_file=None, **kwargs):
        videos.append(video)
        return keep(video, save_file=save_file, **kwargs)

    monkeypatch.setattr(module, "cache_video", capture)
    return videos


def test_gradio_app_generate_and_enhance(env, monkeypatch):
    """Two wired buttons; Generate (7 inputs) answers two requests with
    the videos of ``WanT2V.generate`` given the same arguments; Prompt
    Enhance returns the prompt unchanged when the rewriter cannot load."""
    videos = _capture(monkeypatch, gradio_t2v)
    args = types.SimpleNamespace(
        task="t2v-tiny", ckpt_dir=None, frame_num=1, device="cpu",
        prompt_extend_method="local_qwen", prompt_extend_model=None)
    assert gradio_t2v.build_app(args) is not None
    assert len(env) == 2
    enhance, generate = env[0], env[1]
    assert len(enhance["inputs"]) == 2 and len(generate["inputs"]) == 7

    ref = WanT2V(configs.WAN_CONFIGS["t2v-tiny"], device="cpu")
    for seed in (7, 8):
        path = generate["fn"]("a tiny test video", "64*64", 2, 5.0, 4.0,
                              seed, "")
        assert path == "example.mp4"
        want = ref.generate("a tiny test video", size=(64, 64),
                            frame_num=1, shift=4.0, sampling_steps=2,
                            guide_scale=5.0, n_prompt="", seed=seed)
        got = videos[-1]
        assert got.shape == (3, 1, 64, 64) and np.isfinite(got).all()
        assert np.abs(got).max() <= 1.0
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(videos[0], videos[1])
    assert enhance["fn"]("a cat", "en") == "a cat"


def test_system_prompts_and_dispatch_match_jax(env):
    assert tpe.LM_CH_SYS_PROMPT == jpe.LM_CH_SYS_PROMPT
    assert tpe.LM_EN_SYS_PROMPT == jpe.LM_EN_SYS_PROMPT
    for task in ("t2v-14B", "i2v-14B", "t2v-tiny"):
        for method in ("local_qwen", "dashscope"):
            t = tpe.build_prompt_expander(method, task=task, device="cpu")
            j = jpe.build_prompt_expander(method, task=task)
            assert type(t).__name__ == type(j).__name__
            assert (t.is_vl, t.model_name) == (j.is_vl, j.model_name)
            for lang in ("ch", "en"):
                assert t.decide_system_prompt(lang) \
                    == j.decide_system_prompt(lang)
    assert tpe.QwenPromptExpander().device == "cuda"
    with pytest.raises(ValueError, match="unknown prompt_extend_method"):
        tpe.build_prompt_expander("gpt")


def _fields(out):
    return (out.status, out.prompt, out.seed, out.system_prompt,
            out.message)


@pytest.mark.parametrize("task", ["t2v-14B", "i2v-14B"])
def test_offline_rewriter_keeps_the_prompt_as_jax(env, task):
    """No weights: status False, the prompt unchanged, JAX's message; a
    text rewriter given an image ignores it, a VL one takes the VL path
    (its own message)."""
    t = tpe.build_prompt_expander("local_qwen", task=task, device="cpu")
    j = jpe.build_prompt_expander("local_qwen", task=task)
    for kw in ({}, {"image": object()}):
        got, want = t("a cat", tar_lang="en", seed=5, **kw), \
            j("a cat", tar_lang="en", seed=5, **kw)
        assert _fields(got) == _fields(want)
        assert not got.status and got.prompt == "a cat"
        vl = task.startswith("i2v") and kw
        assert got.message.startswith(
            "failed to load VL rewriter model" if vl
            else "failed to load rewriter model")


def test_dashscope_matches_jax(env, monkeypatch):
    """Without the SDK: status False and JAX's message. With a stub SDK:
    the rewritten prompt, stripped, and the same fields as JAX."""
    t, j = tpe.DashScopePromptExpander(), jpe.DashScopePromptExpander()
    got, want = t("a cat", seed=3), j("a cat", seed=3)
    assert _fields(got) == _fields(want)
    assert not got.status and got.message.startswith("dashscope unavailable")

    calls = []

    def call(model, messages, result_format):
        calls.append((model, messages, result_format))
        msg = types.SimpleNamespace(content="  a cat on a surfboard  ")
        return types.SimpleNamespace(output=types.SimpleNamespace(
            choices=[types.SimpleNamespace(message=msg)]))

    sdk = types.ModuleType("dashscope")
    sdk.Generation = types.SimpleNamespace(call=call)
    monkeypatch.setitem(sys.modules, "dashscope", sdk)
    t = tpe.DashScopePromptExpander(api_key="k")
    j = jpe.DashScopePromptExpander(api_key="k")
    got, want = t("a cat", tar_lang="en", seed=3), \
        j("a cat", tar_lang="en", seed=3)
    assert _fields(got) == _fields(want)
    assert got.status and got.prompt == "a cat on a surfboard"
    assert sdk.api_key == "k" and calls[0] == calls[1]


SIZES = [(1080, 1920), (28, 28), (10, 1500), (720, 1280), (833, 1921),
         (4000, 4000), (56, 1)]


def test_qwen_vl_resize_and_frames_match_jax():
    for h, w in SIZES:
        assert tqv.smart_resize(h, w) == jqv.smart_resize(h, w)
    kw = dict(factor=14, min_pixels=1000, max_pixels=20000)
    assert tqv.smart_resize(512, 512, **kw) == jqv.smart_resize(512, 512,
                                                                **kw)
    with pytest.raises(ValueError):
        tqv.smart_resize(1, 300)
    for n in (0, 1, 27, 28, 29, 55, 57, 300):
        for f in (2, 28):
            for fn in ("round_by_factor", "ceil_by_factor",
                       "floor_by_factor"):
                assert getattr(tqv, fn)(n, f) == getattr(jqv, fn)(n, f)
    for ele, total, fps in [({"nframes": 17}, 100, 30.0),
                            ({"fps": 2.0}, 300, 30.0), ({}, 50, 24.0),
                            ({"fps": 1.0, "min_frames": 10,
                              "max_frames": 20}, 600, 30.0)]:
        assert tqv.smart_nframes(dict(ele), total, fps) == \
            jqv.smart_nframes(dict(ele), total, fps)
    with pytest.raises(AssertionError):
        tqv.smart_nframes({"fps": 2.0, "nframes": 4}, 100, 30.0)


def _png_bytes(h=33, w=57):
    from PIL import Image

    rng = np.random.default_rng(0)
    im = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = _io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


def test_qwen_vl_fetch_and_process_match_jax(tmp_path):
    from PIL import Image

    p = tmp_path / "img.png"
    p.write_bytes(_png_bytes())
    uri = "data:image/png;base64," + base64.b64encode(_png_bytes()).decode()
    for ele in ({"image": str(p)}, {"image_url": uri},
                {"image": "file://" + str(p)},
                {"image": Image.open(p)},
                {"image": str(p), "resized_height": 56,
                 "resized_width": 112}):
        got, want = tqv.fetch_image(dict(ele)), jqv.fetch_image(dict(ele))
        assert got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    rng = np.random.default_rng(1)
    clip = tmp_path / "clip.npy"
    np.save(clip, rng.integers(0, 255, (20, 30, 44, 3), dtype=np.uint8))
    convo = [{"role": "user", "content": [
        {"type": "image", "image": str(p)},
        {"type": "video", "video": str(clip), "nframes": 8},
        {"type": "video", "video": [str(p)] * 3},
        {"type": "text", "text": "hi"}]}]
    (ti, tv), (ji, jv) = (tqv.process_vision_info(convo),
                          jqv.process_vision_info(convo))
    assert len(ti) == len(ji) == 1 and len(tv) == len(jv) == 2
    np.testing.assert_array_equal(np.asarray(ti[0]), np.asarray(ji[0]))
    assert tv[0].dtype == np.float32 and tv[0].shape[:2] == (8, 3)
    np.testing.assert_array_equal(tv[0], jv[0])
    assert len(tv[1]) == len(jv[1]) == 4 and tv[1][-1] is tv[1][-2]
    for a, b in zip(tv[1], jv[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tqv.process_vision_info(
        [{"role": "user", "content": "no vision"}]) == (None, None)


def test_cli_prompt_extend_warns_and_keeps_the_video(env, monkeypatch,
                                                     caplog):
    """``--use_prompt_extend`` with each method, the rewriter failing (no
    weights, no SDK): a warning, and the video of the run without it."""
    videos = _capture(monkeypatch, cli)
    argv = ["--task", "t2v-tiny", "--device", "cpu", "--size", "64*64",
            "--frame_num", "1", "--sample_steps", "1", "--base_seed", "3",
            "--prompt", "a red fox", "--save_file", "clip.mp4"]
    cli.main(argv)
    for method in ("local_qwen", "dashscope"):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cli.main(argv + ["--use_prompt_extend", "--prompt_extend_method",
                             method, "--prompt_extend_target_lang", "en"])
        warned = [r.getMessage() for r in caplog.records
                  if r.levelno == logging.WARNING
                  and "prompt extension failed" in r.getMessage()]
        assert len(warned) == 1
        assert any(r.getMessage() == "prompt: a red fox"
                   for r in caplog.records)
        np.testing.assert_array_equal(videos[-1], videos[0])
    assert len(videos) == 3 and videos[0].shape == (3, 1, 64, 64)
    assert torch.from_numpy(videos[0]).isfinite().all()
