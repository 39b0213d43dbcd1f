"""The port's preprocessing path against the JAX package's: the dataset's
pixel values, ``cli.preprocess`` over one reference-layout checkpoint
directory (same files, latents, embeddings and annotations), resume and
sharding, the split stages, and fine-tuning on the port's own caches
(``--dataset i2v``: ``tests/test_torch_i2v.py``).

The raw clips are ``tests/test_preprocess.py``'s: four 24-frame 36×64
``.npy`` videos at 16 fps, cropped to 32×48 at 9 frames. Both CLIs read
the captions through the same tokenizer (the hash fallback; its ids
agree within one process)."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from moviigen_tpu.cli import preprocess as jpre
from moviigen_tpu.cli import preprocess_stages as jstages
from moviigen_tpu.data import t2v_dataset as jds
from moviigen_tpu_torch.cli import finetune
from moviigen_tpu_torch.cli import preprocess as tpre
from moviigen_tpu_torch.cli import preprocess_stages as tstages
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.data import t2v_dataset as tds
from moviigen_tpu_torch.models import vae as tvae
from test_torch_checkpoint_dir import write_checkpoint_dir

CFGP = WAN_CONFIGS["t2v-tiny"]
CROP = ["--num_frames", "9", "--train_fps", "16", "--max_height", "36",
        "--max_width", "64", "--drop_short_ratio", "0.0",
        "--video_length_tolerance_range", "5.0", "--crop_height", "32",
        "--crop_width", "48"]


def _raw_dataset(root):
    vids = root / "videos"
    vids.mkdir()
    rng = np.random.default_rng(0)
    annos = []
    for i in range(4):
        path = vids / f"clip{i}.npy"
        np.save(path, rng.integers(0, 255, size=(24, 36, 64, 3),
                                   dtype=np.uint8))
        annos.append({"path": str(path), "cap": f"synthetic clip number {i}",
                      "fps": 16, "duration": 1.5,
                      "resolution": {"height": 36, "width": 64}})
    merges = []
    for name, items in (("all", annos), ("two", annos[:2])):
        (root / f"annos_{name}.json").write_text(json.dumps(items))
        merges.append(root / f"merge_{name}.txt")
        merges[-1].write_text(str(root / f"annos_{name}.json") + "\n")
    return [str(m) for m in merges]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs over one checkpoint directory, fp32 encode."""
    root = tmp_path_factory.mktemp("pre")
    merge, merge_two = _raw_dataset(root)
    ckpt = root / "ckpt"
    ckpt.mkdir()
    write_checkpoint_dir(str(ckpt))
    common = ["--data_merge_path", merge, "--task", "t2v-tiny",
              "--model_path", str(ckpt), "--encode_dtype", "float32", *CROP]
    outs = {}
    for name, main, extra in (("jax", jpre.main, []),
                              ("port", tpre.main, ["--device", "cpu"])):
        out = root / name
        outs[name] = (out, main(common + extra + ["--output_dir", str(out)]))
    return dict(root=root, merge=merge, merge_two=merge_two, ckpt=str(ckpt),
                common=common, outs=outs)


def _items(path):
    with open(path) as f:
        return json.load(f)


def _arrays(out, sub):
    return {n: np.load(out / sub / n) for n in sorted(os.listdir(out / sub))}


@pytest.mark.parametrize("random_crop", [True, False])
def test_dataset_pixel_values_equal_jax(runs, random_crop):
    """Same merge file and seed: the same items, frame indices, crops and
    bytes. Each constructor seeds the global ``random``, so the JAX
    dataset is read out in full before the port's is built."""
    kw = dict(num_frames=9, train_fps=16, max_height=36, max_width=64,
              drop_short_ratio=0.0, video_length_tolerance_range=5.0,
              bin_crop_sizes=[{"height": 32, "width": 40}] * 3,
              random_crop=random_crop, seed=5)
    jd = jds.T2VDataset(runs["merge"], **kw)
    want = [jd[i] for i in range(len(jd))]
    td = tds.T2VDataset(runs["merge"], **kw)
    got = [td[i] for i in range(len(td))]
    assert len(got) == len(want) == 4
    assert td.sample_num_frames == jd.sample_num_frames
    assert list(td.aspect_ratios) == list(jd.aspect_ratios)
    for g, w in zip(got, want):
        assert g["pixel_values"].dtype == w["pixel_values"].dtype
        assert g["pixel_values"].tobytes() == w["pixel_values"].tobytes()
        assert (g["text"], g["path"], g["metadata"]) \
            == (w["text"], w["path"], w["metadata"])


def test_same_files(runs):
    (jout, _), (tout, _) = runs["outs"]["jax"], runs["outs"]["port"]
    for sub in ("latent", "prompt_embed"):
        assert sorted(os.listdir(tout / sub)) == sorted(os.listdir(jout / sub))
    assert len(os.listdir(tout / "latent")) == 4


def test_latents_match_jax(runs):
    """fp32 encode on both sides: within the decode tests' 2e-4."""
    jl = _arrays(runs["outs"]["jax"][0], "latent")
    tl = _arrays(runs["outs"]["port"][0], "latent")
    for name, want in jl.items():
        got = tl[name]
        assert got.dtype == np.float32 and got.shape == want.shape \
            == (CFGP.vae.z_dim, 3, 4, 6)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_embeddings_match_jax(runs):
    """Both CLIs run the umT5 in bf16 (the JAX loader's default) and trim
    to the true token length: within the bf16 T5 tests' bound, 3e-2 of
    the embeddings' norm."""
    je = _arrays(runs["outs"]["jax"][0], "prompt_embed")
    te = _arrays(runs["outs"]["port"][0], "prompt_embed")
    for name, want in je.items():
        got = te[name]
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape[1] == CFGP.t5.dim and 0 < got.shape[0] < 16
        assert np.linalg.norm(got - want) < 3e-2 * np.linalg.norm(want)


def test_annotations_equal_jax(runs):
    (jout, jjson), (tout, tjson) = runs["outs"]["jax"], runs["outs"]["port"]
    assert _items(tjson) == _items(jjson)
    for out in (jout, tout):
        latest = out / "videos2caption_latest.json"
        assert os.path.islink(latest)
        assert _items(latest) == _items(jjson)
    stats = _items(tout / "preprocess_stats_shard0.json")
    assert stats["processed"] == 4 and stats["errors"] == {}
    assert len(stats["vae_s"]) == len(stats["t5_s"]) == 4
    assert stats["device"] == "cpu"


def test_resume_processes_nothing(runs):
    tout, _ = runs["outs"]["port"]
    before = {n: os.stat(tout / "latent" / n).st_mtime_ns
              for n in os.listdir(tout / "latent")}
    out_json = tpre.main(runs["common"] + ["--device", "cpu",
                                           "--output_dir", str(tout)])
    stats = _items(tout / "preprocess_stats_shard0.json")
    assert stats["processed"] == 4 and stats["vae_s"] == []
    assert len(_items(out_json)) == 4  # the previous run's items merged
    assert {n: os.stat(tout / "latent" / n).st_mtime_ns
            for n in os.listdir(tout / "latent")} == before


def test_shards_split_the_items(runs):
    """Two shards into one directory: each writes its own processed set
    and stats, the items alternate between them, and the merged
    annotations end with all four."""
    out = runs["root"] / "shards"
    for k in (0, 1):
        tpre.main(runs["common"] + ["--device", "cpu", "--output_dir",
                                    str(out), "--num_shards", "2",
                                    "--shard_idx", str(k)])
        done = _items(out / f"processed_items_shard{k}.json")
        assert [p[-9:] for p in done] == [f"clip{i}.npy"
                                          for i in range(k, 4, 2)]
    assert sorted(i["latent_path"] for i in _items(
        out / "videos2caption_latest.json")) == sorted(
            os.listdir(runs["outs"]["port"][0] / "latent"))


def test_split_stages_match_the_one_pass_cli(runs):
    """``preprocess_stages`` vae (bf16, as in JAX) + text write the
    one-pass CLI's files at its default bf16 encode, bit for bit (two of
    the clips: a bf16 encode is slow on the CPU); the text stage's
    ``--pad_to`` appends zero rows."""
    root, ckpt = runs["root"], runs["ckpt"]
    # oneDNN's first bf16 convolution of a process can round differently
    # from later ones; warm it up so both runs below see the same
    with torch.no_grad():
        tvae.encode(tvae.init_params(CFGP.vae, torch.Generator()
                                     .manual_seed(0), encoder=True),
                    torch.zeros(1, 3, 1, 16, 16).bfloat16(), CFGP.vae)
    base = ["--data_merge_path", runs["merge_two"], "--task", "t2v-tiny",
            "--model_path", ckpt, "--device", "cpu", *CROP]
    one = root / "one_bf16"
    tpre.main(base + ["--output_dir", str(one)])
    st = root / "stages"
    temp = tstages.main(["vae", *base, "--output_dir", str(st)])
    final = tstages.main(["text", "--json_path", temp, "--task", "t2v-tiny",
                          "--model_path", ckpt, "--device", "cpu",
                          "--output_dir", str(st)])
    one_items = {i["latent_path"]: i for i in _items(
        one / "videos2caption_latest.json")}
    items = _items(final)
    assert sorted(one_items) == sorted(i["latent_path"] for i in items)
    for item in items:
        want = one_items[item["latent_path"]]
        assert item == {k: want[k] for k in item}
        for sub, key in (("latent", "latent_path"),
                         ("prompt_embed", "prompt_embed_path")):
            np.testing.assert_array_equal(np.load(st / sub / item[key]),
                                          np.load(one / sub / want[key]))
    padded = tstages.main(["text", "--json_path", temp, "--task",
                           "t2v-tiny", "--model_path", ckpt, "--device",
                           "cpu", "--pad_to", "12", "--output_dir",
                           str(root / "padded")])
    for item in _items(padded):
        emb = np.load(root / "padded" / "prompt_embed" /
                      item["prompt_embed_path"])
        trim = np.load(st / "prompt_embed" / item["prompt_embed_path"])
        assert emb.shape == (12, CFGP.t5.dim)
        np.testing.assert_array_equal(emb[:len(trim)], trim)
        assert not emb[len(trim):].any()


def test_validation_stage_matches_jax(runs, tmp_path):
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    for i, text in enumerate(("validation prompt zero",
                              "a slow pan over a misty lake at dawn")):
        (prompts / f"p{i}.txt").write_text(text)
    args = ["validation", "--prompt_dir", str(prompts), "--task",
            "t2v-tiny", "--model_path", runs["ckpt"]]
    jdir = jstages.main(args + ["--output_dir", str(tmp_path / "jax")])
    tdir = tstages.main(args + ["--device", "cpu", "--output_dir",
                                str(tmp_path / "port")])
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) \
        == ["p0.npy", "p1.npy"]
    for name in os.listdir(jdir):
        got, want = np.load(os.path.join(tdir, name)), \
            np.load(os.path.join(jdir, name))
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) < 3e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("signum", [signal.SIGINT, signal.SIGTERM])
def test_a_signal_saves_the_processed_set_and_exits_nonzero(
        runs, tmp_path, monkeypatch, signum):
    """SIGINT/SIGTERM mid-run saves the processed set, then exits with
    128 + the signal's number (JAX exits 0), and the handlers before the
    run are back."""
    def interrupted_run(args, device, processed, save_processed):
        processed.add("clip0")
        signal.raise_signal(signum)
        raise AssertionError("the handler did not exit")

    monkeypatch.setattr(tpre, "_run", interrupted_run)
    before = signal.getsignal(signum)
    with pytest.raises(SystemExit) as exc:
        tpre.main(runs["common"] + ["--device", "cpu",
                                    "--output_dir", str(tmp_path)])
    assert exc.value.code == 128 + signum
    assert _items(tmp_path / "processed_items_shard0.json") == ["clip0"]
    assert signal.getsignal(signum) is before


def test_without_a_card_the_cli_raises(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main, argv in ((tpre.main, runs["common"]),
                       (tstages.main, ["text", "--json_path", "x.json"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--output_dir", str(tmp_path)])


def test_finetune_reads_the_output(runs, tmp_path):
    """The port's latent dataset reads the port's caches, and
    ``cli.finetune`` takes a step on them with a finite loss."""
    from moviigen_tpu_torch.training.data import LatentDataset

    tout, _ = runs["outs"]["port"]
    data_json = str(tout / "videos2caption_latest.json")
    ds = LatentDataset(data_json, num_latent_t=2,
                       txt_max_len=CFGP.model.text_len,
                       text_dim=CFGP.model.text_dim)
    latent, embed, mask = ds[0]
    assert latent.shape == (CFGP.vae.z_dim, 2, 4, 6)
    assert embed.shape == (CFGP.model.text_len, CFGP.model.text_dim)
    assert 0 < mask.sum() < CFGP.model.text_len
    record = finetune.main([
        "--task", "t2v-tiny", "--device", "cpu", "--data_json_path",
        data_json, "--num_latent_t", "2", "--train_batch_size", "2",
        "--max_train_steps", "1", "--checkpointing_steps", "100",
        "--output_dir", str(tmp_path / "train")])
    assert record["step"] == 1 and np.isfinite(record["loss"]).all()
