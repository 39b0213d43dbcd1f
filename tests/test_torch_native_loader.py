"""The port's native reader pool (``moviigen_tpu_torch/native``) and the
loader that reads through it, against the JAX package's: the JAX cases of
tests/test_native_loader.py, batches bit-equal with and without the pool
and to JAX's ``DataLoader``, the fallback when the library cannot be
built, and where the library lands."""

import json
import logging
import pathlib

import numpy as np
import pytest

from moviigen_tpu.training import data as jdata
from moviigen_tpu_torch.native import loader
from moviigen_tpu_torch.native import (NativeReaderPool, native_available,
                                       read_npy_batch)
from moviigen_tpu_torch.training import data as tdata

PKG = pathlib.Path(loader.__file__).resolve().parent.parent


def test_library_builds_under_the_package_build_dir():
    assert native_available()
    lib = loader._target()
    assert lib.parent == PKG / "_build" and lib.exists()
    assert lib.name.startswith("cache_loader-") and lib.suffix == ".so"
    assert not (PKG / "native" / "src" / "libcache_loader.so").exists()


def test_read_npy_batch_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    paths, refs = [], []
    for i, shape in enumerate([(4, 8), (3, 5, 7), (128,), (2, 2, 2, 2)]):
        arr = rng.standard_normal(shape).astype(
            [np.float32, np.float16, np.int32, np.float64][i % 4])
        p = tmp_path / f"a{i}.npy"
        np.save(p, arr)
        paths.append(str(p))
        refs.append(arr)

    pool = NativeReaderPool(num_threads=3)
    got = read_npy_batch(pool, paths)
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    pool.close()


def test_many_concurrent_reads(tmp_path):
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((64, 64)).astype(np.float32)
            for _ in range(32)]
    paths = []
    for i, a in enumerate(arrs):
        p = tmp_path / f"f{i}.npy"
        np.save(p, a)
        paths.append(str(p))
    pool = NativeReaderPool(num_threads=8)
    got = read_npy_batch(pool, paths)
    for g, r in zip(got, arrs):
        np.testing.assert_array_equal(g, r)
    pool.close()


def test_missing_file_raises(tmp_path):
    pool = NativeReaderPool(num_threads=1)
    dst = np.empty((4,), np.float32)
    t = pool.submit(str(tmp_path / "nope.npy"), dst)
    with pytest.raises(IOError):
        pool.wait(t)
    # a batch with a missing file raises before any read is submitted:
    # every header is read first
    np.save(tmp_path / "ok.npy", np.zeros(3, np.float32))
    assert loader._npy_header(str(tmp_path / "ok.npy")) == (
        np.dtype(np.float32), (3,), 128, False)
    with pytest.raises(FileNotFoundError):
        read_npy_batch(pool, [str(tmp_path / "ok.npy"),
                              str(tmp_path / "gone.npy")])
    pool.close()


@pytest.fixture
def dataset(tmp_path):
    d = tmp_path / "ds"
    (d / "latent").mkdir(parents=True)
    (d / "prompt_embed").mkdir()
    rng = np.random.default_rng(0)
    annos = []
    for i in range(6):
        np.save(d / "latent" / f"v{i}.npy",
                rng.standard_normal((4, 3, 8, 8)).astype(np.float32))
        np.save(d / "prompt_embed" / f"v{i}.npy",
                rng.standard_normal((7 + 8 * (i % 2), 32))
                .astype(np.float32))
        annos.append({"latent_path": f"v{i}.npy",
                      "prompt_embed_path": f"v{i}.npy",
                      "length": 3, "aspect_ratio_bin": 0})
    (d / "v.json").write_text(json.dumps(annos))
    return str(d / "v.json")


def _batches(mod, json_path, use_native, prefetch=0):
    ds = mod.LatentDataset(json_path, num_latent_t=2, txt_max_len=12,
                           text_dim=32)
    sampler = mod.AspectRatioLengthBucketSampler(
        batch_size=2, dataset_size=len(ds), rank=0, world_size=1,
        lengths=ds.lengths, aspect_ratios=list(ds.aspect_ratios))
    dl = mod.DataLoader(ds, sampler, batch_size=2, prefetch=prefetch,
                        use_native=use_native)
    return list(dl), dl


def _assert_equal_batches(got, want):
    assert len(got) == len(want) == 3
    for bg, bw in zip(got, want):
        for a, b in zip(bg, bw):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_item_npy_paths_match_jax(dataset):
    kw = dict(num_latent_t=2, txt_max_len=12, text_dim=32)
    tds = tdata.LatentDataset(dataset, **kw)
    jds = jdata.LatentDataset(dataset, **kw)
    for i in range(len(tds)):
        assert tds.item_npy_paths(i) == jds.item_npy_paths(i)
    assert tdata.LatentDataset(dataset, cfg_rate=0.1, **kw) \
        .item_npy_paths(0) is None


@pytest.mark.parametrize("prefetch", [0, 2])
def test_dataloader_batches_with_the_pool(dataset, prefetch):
    """With the pool, without it, and JAX's loader: the same batches,
    bit for bit; the pool read every batch."""
    native, dl = _batches(tdata, dataset, True, prefetch)
    assert dl.uses_native
    assert (dl.native_batches, dl.python_batches) == (3, 0)
    python, dl_py = _batches(tdata, dataset, False, prefetch)
    assert not dl_py.uses_native
    assert (dl_py.native_batches, dl_py.python_batches) == (0, 3)
    jax_batches, _ = _batches(jdata, dataset, False, prefetch)
    _assert_equal_batches(native, python)
    _assert_equal_batches(native, jax_batches)
    dl.close()
    assert not dl.uses_native


def test_build_failure_falls_back_with_a_warning(dataset, tmp_path,
                                                 monkeypatch, caplog):
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(loader, "_CXX", str(tmp_path / "no-such-g++"))
    with caplog.at_level(logging.WARNING):
        got, dl = _batches(tdata, dataset, True)
    assert any("native cache loader build failed" in r.getMessage()
               for r in caplog.records)
    assert not dl.uses_native and not native_available()
    assert (dl.native_batches, dl.python_batches) == (0, 3)
    want, _ = _batches(jdata, dataset, False)
    _assert_equal_batches(got, want)
    with pytest.raises(RuntimeError, match="unavailable"):
        NativeReaderPool()
