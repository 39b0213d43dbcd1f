"""The fine-tune driver: the full fine-tune's step as ``cli/finetune.py``
runs it (``make_optimizer``, ``make_train_step``, the ``DataLoader`` over
a ``LatentDataset`` with its bucketing sampler and prefetch; batch to the
device, the step, the loss read back), on a synthetic preprocessed
dataset. The CLI itself is not run: its final save of a full fine-tune
writes the fp32 weights and AdamW's two moments (16 GB for the 1.3B).

A traffic file (``driver: finetune``) gives the items (``items``, the
latent shape ``latent_shape`` [C, F, H, W], the range of prompt lengths
``text_tokens``), the batch size, the ``TrainConfig`` fields under
``train`` and ``check_steps``, the steps the check follows.

Set-up writes the items (latents and T5 embeddings drawn from the seed)
under ``TMPDIR``, builds the model as the CLI does (fp32 masters), copies
the benchmark's weights in, and takes ``check_steps`` steps through the
window's own loop on distinct items, keeping what the check compares:
each step's loss, the first gradient of every leaf as the optimizer holds
it (m / (1 − β₁) after step 1) and every leaf's change after the last.
The window then takes steps until ``seconds`` have passed, finishing the
last. After it the peak memory is read, the program freed, and the
reference takes the same steps from the same weights and items.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from . import core, counters, program
from .reference import dit as ref_dit
from .reference import train as ref_train
from .reference import weights as W
from .tracing import Tracer


def item(seed: int, tr: dict, i: int, text_dim: int):
    """Item ``i``'s latent [C, F, H, W] and embedding [n, text_dim], fp32
    numpy, drawn from the seed on the CPU generator of its own."""
    gen = torch.Generator().manual_seed(W.group_seed(seed, "item", str(i)))
    lat = torch.randn(tuple(tr["latent_shape"]), generator=gen)
    lo, hi = tr["text_tokens"]
    n = int(torch.randint(lo, hi + 1, (1,), generator=gen))
    emb = torch.randn((n, text_dim), generator=gen)
    return lat.numpy(), emb.numpy()


def write_items(root: str, seed: int, tr: dict, text_dim: int):
    """The preprocessed layout ``cli/finetune.py`` reads (``latent/``,
    ``prompt_embed/``, ``videos2caption.json``); returns the json's path
    and each item's first latent values (to tell the items apart)."""
    os.makedirs(os.path.join(root, "latent"))
    os.makedirs(os.path.join(root, "prompt_embed"))
    annos, heads = [], []
    for i in range(tr["items"]):
        lat, emb = item(seed, tr, i, text_dim)
        np.save(os.path.join(root, "latent", f"{i}.npy"), lat)
        np.save(os.path.join(root, "prompt_embed", f"{i}.npy"), emb)
        annos.append({"latent_path": f"{i}.npy",
                      "prompt_embed_path": f"{i}.npy", "length": 1,
                      "aspect_ratio_bin": 0})
        heads.append(lat.reshape(-1)[:8].copy())
    path = os.path.join(root, "videos2caption.json")
    with open(path, "w") as f:
        json.dump(annos, f)
    return path, heads


def which(latents: np.ndarray, heads) -> int:
    first = latents[0].reshape(-1)[:8]
    for i, h in enumerate(heads):
        if np.array_equal(first, h):
            return i
    raise RuntimeError("the loader gave a batch that is no item")


def reference_batch(seed: int, tr: dict, i: int, text_len: int,
                    text_dim: int, device) -> dict:
    lat, emb = item(seed, tr, i, text_dim)
    ctx = np.zeros((text_len, text_dim), np.float32)
    n = min(len(emb), text_len)
    ctx[:n] = emb[:n]
    return {"latents": torch.from_numpy(lat)[None].to(device),
            "context": torch.from_numpy(ctx)[None].to(device)}


@torch.no_grad()
def leaf_norms(model, opt, b1: float):
    names = [n for n, _ in model.named_parameters()]
    return {n: float((m / (1 - b1)).double().norm())
            for n, m in zip(names, opt.m)}


@torch.no_grad()
def leaf_changes(model, m: dict, seed: int) -> dict:
    params = dict(model.named_parameters())
    device = next(model.parameters()).device
    out = {}
    for group in W.draw_all(seed, "dit", W.dit_specs(m, "float32"),
                            W.dit_init(m), device):
        for name, p0 in group.items():
            out[name] = float((params[name] - p0).double().norm())
    return out


def run(bench: core.Bench, cell: dict, seed: int, seconds: float,
        trace: bool, device: str, control: bool = False) -> dict:
    """One run of a fine-tune cell. With ``control`` (``control.py``) the
    reference is also run with every linear's operands rounded through
    fp8, and the result also holds that run's readings in the program's
    place."""
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs
    from moviigen_tpu_torch.training import (TrainConfig, make_optimizer,
                                             make_train_step)
    from moviigen_tpu_torch.training.data import (
        DataLoader, LatentDataset,
        SPAwareAspectRatioLengthBucketDistributedSampler)

    conf = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    limits = bench.limits(cell["name"])
    cuda = device.startswith("cuda")
    cfg = program.pipeline_config(conf)
    m = conf["model"]
    hp = dict(tr["train"], num_train_timesteps=conf["num_train_timesteps"])
    rng = np.random.default_rng([seed, 3])
    sampler_seed, gen_seed = (int(s) for s in rng.integers(0, 2 ** 62, 2))
    tmp = tempfile.mkdtemp(prefix="moviigen_bench_")
    loader = batches = None
    try:
        # ---- set-up: the items, the model, the optimizer, the step
        core.log("program imported")
        json_path, heads = write_items(tmp, seed, tr, m["text_dim"])
        dataset = LatentDataset(json_path, tr["latent_shape"][1],
                                txt_max_len=m["text_len"],
                                text_dim=m["text_dim"], seed=sampler_seed)
        bs = tr["batch_size"]
        sampler = SPAwareAspectRatioLengthBucketDistributedSampler(
            batch_size=bs, dataset_size=len(dataset), rank=0, world_size=1,
            sp_size=1, lengths=dataset.lengths,
            aspect_ratios=list(dataset.aspect_ratios), seed=sampler_seed)
        loader = DataLoader(dataset, sampler, batch_size=bs)
        model = WanModel(cfg.model, dtype=torch.float32, device=device)
        model.init_weights(torch.Generator(device=device).manual_seed(0))
        program.load_module(model, "dit", W.dit_specs(m, "float32"),
                            W.dit_init(m), seed)
        model.train()
        if cuda:
            torch.cuda.synchronize()
        core.log("items written, model built")
        tc = TrainConfig(
            learning_rate=hp["learning_rate"],
            weight_decay=hp["weight_decay"], betas=tuple(hp["betas"]),
            eps=hp["eps"], max_grad_norm=hp["max_grad_norm"],
            weighting_scheme=hp["weighting_scheme"],
            num_train_timesteps=hp["num_train_timesteps"],
            remat=hp["remat"], residual_dtype=hp["residual_dtype"])
        opt = make_optimizer(list(model.parameters()), tc)
        gen = torch.Generator(device=device).manual_seed(gen_seed)
        c, f, h, w = tr["latent_shape"]
        pt, ph, pw = m["patch_size"]
        grid = (f // pt, h // ph, w // pw)
        rope = rope_3d_freqs(grid, m["dim"] // m["num_heads"], device=device)
        train_step = make_train_step(model, tc, rope, opt, generator=gen)

        def epochs():
            epoch = 0
            while True:
                sampler.set_epoch(epoch)
                dataset.set_epoch(epoch)
                yield from loader
                epoch += 1

        batches = epochs()

        def one_step():
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.loader_wait"):
                latents, embeds, _, embed_mask = next(batches)
            wait = time.perf_counter() - t0
            with torch.profiler.record_function("bench.train_step"):
                embeds = embeds * embed_mask[..., None]
                batch = {"latents": torch.from_numpy(latents).to(device),
                         "context": torch.from_numpy(embeds).to(device)}
                metrics = train_step(batch)
                loss = float(metrics["loss"])
            return wait, loss, latents

        first = {"loss": [], "items": []}
        for s in range(tr["check_steps"]):
            _, loss, latents = one_step()
            first["loss"].append(loss)
            first["items"].append(which(latents, heads))
            if s == 0:
                first["grad1"] = leaf_norms(model, opt, tc.betas[0])
        first["change"] = leaf_changes(model, m, seed)
        core.log(f"{tr['check_steps']} checked steps taken")
        if len(set(first["items"])) != len(first["items"]):
            raise RuntimeError(f"the checked steps repeat an item: "
                               f"{first['items']}")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        # ---- the window
        tracer = Tracer(trace, cuda)
        tracer.start()
        setup_s = core.process_age()
        waits, ends = [], []
        t0 = time.perf_counter()
        with tracer.window():
            while True:
                wait, _, _ = one_step()
                waits.append(wait)
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
        window_s = time.perf_counter() - t0
        window = tracer.stop()
        each = np.diff([0.0] + ends)
        core.log(f"window closed: {len(waits)} steps in {window_s:.3f} s "
                 f"(each {', '.join(f'{s:.4f}' for s in each)})")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        if batches is not None:
            batches.close()
        if loader is not None:
            loader.close()
        shutil.rmtree(tmp, ignore_errors=True)
    del model, opt, train_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference: the same steps from the same weights and items
    with ref_dit.exact_fp32():
        ref = ref_train.run(
            seed, m, hp,
            [reference_batch(seed, tr, i, m["text_len"], m["text_dim"],
                             device) for i in first["items"]],
            gen_seed, device)
    out = sorted(set(ref["grad1"]) - set(ref_train.moved_leaves(ref["grad1"])))
    core.log(f"reference steps; {len(out)} leaves left out of the gaps: "
             f"{', '.join(out[:6])}{' ...' if len(out) > 6 else ''}")
    readings = compare(first, ref)
    checks, correct = core.judge(readings, limits)
    ctl = None
    if control:
        with ref_dit.exact_fp32():
            fp8 = ref_train.run(
                seed, m, hp,
                [reference_batch(seed, tr, i, m["text_len"], m["text_dim"],
                                 device) for i in first["items"]],
                gen_seed, device, fp8=True)
        ctl = compare(fp8, ref)

    steps = len(waits)
    tokens = counters.tokens_of(m, tr["latent_shape"])
    ops, nbytes = counters.attention_work(m, tokens, batch=bs, backward=True)
    ctx = dict(kind="train", window_s=window_s, steps=steps,
               loader_wait_s=waits,
               flops=steps * 3 * counters.dit_flops(m, tokens, batch=bs),
               attn_ops=steps * ops, attn_bytes=steps * nbytes, trace=window,
               card_kind=torch.cuda.get_device_name(0) if cuda else None)
    return dict(correct=correct, attempted=steps, failed=0, checks=checks,
                control=ctl,
                window=window, peak_bytes=peak, ctx=ctx,
                end_to_end={"setup_s": setup_s,
                            "train_step_s": window_s / steps,
                            "peak_gib": peak / 2 ** 30})


def compare(prog: dict, ref: dict) -> dict:
    """The numbers the check compares: the worst step's loss gap over the
    reference's loss, and the worst moved leaf's gap of first-gradient
    norms and of change norms (``reference/train.py::leaf_gaps``)."""
    keep = ref_train.moved_leaves(ref["grad1"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    grad, _ = ref_train.worst(ref_train.leaf_gaps(prog["grad1"],
                                                  ref["grad1"], keep))
    change, _ = ref_train.worst(ref_train.leaf_gaps(prog["change"],
                                                    ref["change"], keep))
    return {"loss_rel": loss, "grad_leaf_gap": grad,
            "change_leaf_gap": change}
