"""The port's host-side data tools against the JAX package's copies:
``cli/video_tools.py`` (resize, metadata, copy-csv) on the same small mp4
and caption CSV, ``data/video_reader.py`` on mp4 and ``.npy`` clips, and
``data/transforms.py`` on random uint8 clips, all exactly."""

import json
import random

import numpy as np
import pytest

from moviigen_tpu.cli import video_tools as jvt
from moviigen_tpu.data import transforms as JT
from moviigen_tpu.data import video_reader as jvr
from moviigen_tpu.utils.io import cache_video
from moviigen_tpu_torch.cli import video_tools as tvt
from moviigen_tpu_torch.data import transforms as TT
from moviigen_tpu_torch.data import video_reader as tvr


def _write_mp4(path, t=12, h=90, w=160, fps=12, seed=0):
    frames = np.random.default_rng(seed).integers(0, 255, (t, h, w, 3))
    out = cache_video(frames.astype(np.float32).transpose(3, 0, 1, 2),
                      save_file=str(path), fps=fps, value_range=(0, 255))
    if out is None or not str(out).endswith(".mp4"):
        pytest.skip("no mp4 encoder in environment")
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two clips (16:9 and 1:1) under a sub-folder with a caption CSV."""
    root = tmp_path_factory.mktemp("videos")
    sub = root / "src" / "sub"
    sub.mkdir(parents=True)
    _write_mp4(sub / "a.mp4", h=90, w=160)
    _write_mp4(sub / "b.mp4", h=120, w=120, seed=1)
    (sub / "captions.csv").write_text(
        "Filename,Video Description\na.mp4,a wide shot\nb.mp4,a square\n")
    return root


@pytest.mark.parametrize("w,h", [(1920, 1080), (1600, 900), (1920, 832),
                                 (1080, 1920), (1000, 600)])
def test_16_9_rule(w, h):
    assert tvt.is_16_9_ratio(w, h) == jvt.is_16_9_ratio(w, h)


@pytest.mark.parametrize("n,src,dst", [(12, 12.0, 6.0), (10, 10.0, 20.0),
                                       (81, 30.0, 16.0), (5, 0.0, 16.0)])
def test_resample_indices(n, src, dst):
    assert tvt._resample_indices(n, src, dst) \
        == jvt._resample_indices(n, src, dst)


def test_resize_writes_what_jax_writes(tree):
    outs = {}
    for name, mod in (("jax", jvt), ("port", tvt)):
        out = tree / f"resized_{name}"
        assert mod.main(["resize", "--input_dir", str(tree / "src"),
                         "--output_dir", str(out), "--width", "64",
                         "--height", "36", "--fps", "6",
                         "--max_workers", "1"]) == 0
        assert not (out / "sub" / "b.mp4").exists()  # not 16:9
        outs[name] = str(out / "sub" / "a.mp4")
    assert tvr.probe_video(outs["port"]) == jvr.probe_video(outs["jax"]) \
        == (6, 6.0, 36, 64)
    np.testing.assert_array_equal(tvr.read_video_frames(outs["port"]),
                                  jvr.read_video_frames(outs["jax"]))


def test_metadata_and_copy_csv_match_jax(tree):
    for cmd in ("metadata", "copy-csv"):
        got = {}
        for name, mod in (("jax", jvt), ("port", tvt)):
            out = tree / f"{cmd}_{name}"
            if cmd == "metadata":
                assert mod.main(["metadata", str(tree / "src"),
                                 f"{out}.json"]) == 0
                got[name] = json.loads(open(f"{out}.json").read())
            else:
                assert mod.main(["copy-csv", "--src_dir", str(tree / "src"),
                                 "--dst_dir", str(out)]) == 0
                got[name] = (out / "sub" / "captions.csv").read_text()
        assert got["port"] == got["jax"]
    entries = json.loads(open(tree / "metadata_port.json").read())
    assert [e["cap"] for e in entries] == [["a wide shot"], ["a square"]]


@pytest.mark.parametrize("indices", [None, [0, 3, 3, 11]])
@pytest.mark.parametrize("kind", ["mp4", "npy", "npz"])
def test_video_reader_matches_jax(tree, tmp_path, kind, indices):
    path = str(tree / "src" / "sub" / "a.mp4")
    if kind != "mp4":
        frames = np.random.default_rng(2).integers(
            0, 256, (12, 9, 16, 3), np.uint8)
        path = str(tmp_path / f"clip.{kind}")
        (np.save if kind == "npy" else np.savez)(path, frames)
    assert tvr.probe_video(path) == jvr.probe_video(path)
    got = tvr.read_video_frames(path, indices)
    np.testing.assert_array_equal(got, jvr.read_video_frames(path, indices))
    assert got.dtype == np.uint8 and got.shape[-1] == 3


def _clip(seed=0, t=4, h=37, w=53):
    return np.random.default_rng(seed).integers(0, 256, (t, 3, h, w),
                                                dtype=np.uint8)


# (name, call) over the numpy [T, C, H, W] zoo; random ones get their own
# random.Random, and the global one is re-seeded before each side
TRANSFORMS = {
    "crop": lambda T, c: T.crop(c, 3, 5, 20, 30),
    "resize_up": lambda T, c: T.resize(c, (60, 80)),
    "resize_down": lambda T, c: T.resize(c, (20, 26)),
    "resize_scale": lambda T, c: T.resize_scale(c, (24, 24)),
    "resized_crop": lambda T, c: T.resized_crop(c, 2, 3, 20, 30, (40, 48)),
    "center_crop": lambda T, c: T.center_crop(c, (20, 30)),
    "center_crop_short_edge": lambda T, c: T.center_crop_using_short_edge(c),
    "center_crop_th_tw": lambda T, c: T.center_crop_th_tw(c, 16, 24, True),
    "random_shift_crop": lambda T, c: T.random_shift_crop(
        c, rng=random.Random(1)),
    "normalize_video": lambda T, c: T.normalize_video(c),
    "normalize": lambda T, c: T.normalize(
        np.moveaxis(T.normalize_video(c), 1, 0), (0.5, 0.4, 0.3),
        (0.2, 0.3, 0.4)),
    "hflip": lambda T, c: T.hflip(c),
    "RandomCropVideo": lambda T, c: T.RandomCropVideo(
        16, rng=random.Random(2))(c),
    "SpatialStrideCropVideo": lambda T, c: T.SpatialStrideCropVideo(8)(c),
    "LongSideResizeVideo": lambda T, c: T.LongSideResizeVideo(40)(c),
    "CenterCropResizeVideo": lambda T, c: T.CenterCropResizeVideo(
        (24, 24))(c),
    "UCFCenterCropVideo": lambda T, c: T.UCFCenterCropVideo(24)(c),
    "KineticsRandomCropResizeVideo": lambda T, c:
        T.KineticsRandomCropResizeVideo((20, 28))(c),
    "CenterCropVideo": lambda T, c: T.CenterCropVideo((20, 30))(c),
    "Normalize255": lambda T, c: T.Normalize255()(c),
    "RandomHorizontalFlipVideo": lambda T, c: T.RandomHorizontalFlipVideo(
        p=0.5, rng=random.Random(3))(c),
    "Compose": lambda T, c: T.Compose([T.Normalize255(),
                                       T.CenterCropResizeVideo((24, 32))])(c),
    "TemporalRandomCrop": lambda T, c: np.asarray(T.TemporalRandomCrop(
        32, rng=random.Random(4))(100)),
    "DynamicSampleDuration": lambda T, c: np.asarray(
        T.DynamicSampleDuration(4, True, rng=random.Random(9))(21, 8, 8)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, seed):
    clip = _clip(seed)
    random.seed(seed)
    want = TRANSFORMS[name](JT, clip.copy())
    random.seed(seed)
    got = TRANSFORMS[name](TT, clip.copy())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
