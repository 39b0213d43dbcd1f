"""Training data layer: precomputed-latent dataset + shape-bucket samplers.

The port's own copy of ``moviigen_tpu/training/data.py`` (host numpy, no
JAX; the tests hold the items and the index order to the JAX package's).
Parity targets:
- ``scripts/dataset/latent_datasets.py`` (LatentDataset +
  latent_collate_function): loads ``latent/*`` + ``prompt_embed/*``
  caches, trims latents to the last ``num_latent_t`` frames, pads/truncates
  prompt embeds to 512 with a mask, pads batches to the max T/H/W with a
  4D latent attention mask. (The reference's collate passes the pad
  amounts in transposed dim order — F.pad pads (W,H,T) last-first,
  latent_datasets.py:155-163 — a latent bug fixed here as in the JAX
  package; identical behavior whenever batch shapes already match, which
  the bucket samplers guarantee.)
- ``scripts/dataset/aspect_ratio_length_bucket_sampler.py``: two-level
  (aspect-ratio bin × quantile length bin) bucketing, in-bucket shuffle,
  pad-don't-drop global batches, per-rank slices; the SP-aware variant
  maps ``rank // sp_size`` → data-parallel rank so every rank in an SP
  group loads identical samples (L358-490).

Tensor caches load from ``.npy`` / ``.npz`` / ``.safetensors`` (the
port's own reader) or ``.pt`` (the reference's format).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.safetensors import load_file


def load_tensor(path: str) -> np.ndarray:
    """Load a cached tensor: .npy/.npz/.safetensors/.pt."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        z = np.load(path)
        return z[list(z.keys())[0]]
    if path.endswith(".safetensors"):
        tensors = load_file(path)
        t = tensors[sorted(tensors)[0]]  # safe_open's first key
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    # torch pickle (.pt) — the reference's cache format
    t = torch.load(path, map_location="cpu", weights_only=True)
    return t.float().numpy()


class LatentDataset:
    """ref latent_datasets.py:10-141."""

    def __init__(self, json_path: str, num_latent_t: int,
                 cfg_rate: float = 0.0, txt_max_len: int = 512,
                 prompt_type: str = "prompt_embed_path", seed: int = 42,
                 keep_aspect_ratio_bins: Optional[Sequence[int]] = (0, 1),
                 resolution_mix: Optional[str] = None,
                 resolution_mix_p: float = 0.2,
                 text_dim: int = 4096):
        self.json_path = json_path
        self.dataset_dir = os.path.dirname(json_path)
        self.latent_dir = os.path.join(self.dataset_dir, "latent")
        self.prompt_embed_dir = os.path.join(self.dataset_dir,
                                             "prompt_embed")
        self.num_latent_t = num_latent_t
        self.cfg_rate = cfg_rate
        self.txt_max_len = txt_max_len
        self.prompt_type = prompt_type
        self.base_seed = seed
        self.resolution_mix = resolution_mix
        self.resolution_mix_p = resolution_mix_p
        self.text_dim = text_dim
        self.epoch = 0

        with open(json_path) as f:
            annos = json.load(f)

        # aspect-ratio filtering (ref L37-45)
        self.data_anno: List[Dict[str, Any]] = []
        if annos and "aspect_ratio_bin" in annos[0] \
                and keep_aspect_ratio_bins is not None:
            keep = set(keep_aspect_ratio_bins)
            self.data_anno = [a for a in annos
                              if a["aspect_ratio_bin"] in keep]
        else:
            self.data_anno = list(annos)

        self.aspect_ratios = np.asarray(
            [a.get("aspect_ratio_bin", 0) for a in self.data_anno])
        self.lengths = [a.get("length", 1) for a in self.data_anno]

        if not self.data_anno:
            raise ValueError(
                f"LatentDataset is empty after filtering ({json_path}); "
                "check aspect_ratio_bin filters and the annotation json")

        self.uncond_prompt_embed = np.zeros((txt_max_len, text_dim),
                                            np.float32)
        self.uncond_prompt_mask = np.zeros((txt_max_len,), np.int64)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.data_anno)

    def _resolve_latent_dir(self, idx: int) -> str:
        import random

        latent_dir = self.latent_dir
        if self.resolution_mix is not None:
            local = random.Random(self.base_seed + self.epoch + idx)
            if local.random() < self.resolution_mix_p:
                latent_dir = os.path.join(self.dataset_dir,
                                          self.resolution_mix)
        return latent_dir

    def materialize(self, latent: np.ndarray, embed: np.ndarray):
        """Apply the trim/pad/mask post-processing to raw cache arrays
        (same transforms as __getitem__)."""
        if latent.ndim == 5:
            latent = latent[0]
        latent = latent[:, -self.num_latent_t:]
        orig_len = embed.shape[0]
        if self.txt_max_len > 0:
            if orig_len < self.txt_max_len:
                pad = np.zeros((self.txt_max_len - orig_len,
                                embed.shape[1]), embed.dtype)
                embed = np.concatenate([embed, pad], axis=0)
            elif orig_len > self.txt_max_len:
                embed = embed[: self.txt_max_len]
                orig_len = self.txt_max_len
            mask = np.zeros((self.txt_max_len,), np.int64)
            mask[:orig_len] = 1
        else:
            mask = np.ones((orig_len,), np.int64)
        return latent.astype(np.float32), embed.astype(np.float32), mask

    def __getitem__(self, idx: int):
        import random

        anno = self.data_anno[idx]
        latent = load_tensor(os.path.join(self._resolve_latent_dir(idx),
                                          anno["latent_path"]))
        if random.random() < self.cfg_rate:
            # uncond zero-embedding draw (ref L52-54; asserted-unreachable
            # there because cfg_rate defaults to 0)
            if latent.ndim == 5:
                latent = latent[0]
            latent = latent[:, -self.num_latent_t:]
            return (latent.astype(np.float32), self.uncond_prompt_embed,
                    self.uncond_prompt_mask)

        embed = load_tensor(
            os.path.join(self.prompt_embed_dir, anno[self.prompt_type]))
        return self.materialize(latent, embed)


def latent_collate_function(batch):
    """Pad to batch-max (T, H, W) + 4D latent attention mask
    (ref latent_datasets.py:144-182, with the pad-order bug fixed)."""
    latents, embeds, masks = zip(*batch)
    max_t = max(x.shape[1] for x in latents)
    max_h = max(x.shape[2] for x in latents)
    max_w = max(x.shape[3] for x in latents)

    out = np.zeros((len(latents), latents[0].shape[0], max_t, max_h, max_w),
                   np.float32)
    attn = np.zeros((len(latents), max_t, max_h, max_w), np.float32)
    for i, x in enumerate(latents):
        c, t, h, w = x.shape
        out[i, :, :t, :h, :w] = x
        attn[i, :t, :h, :w] = 1.0
    return (out, np.stack(embeds), attn, np.stack(masks))


class AspectRatioLengthBucketSampler:
    """ref aspect_ratio_length_bucket_sampler.py:35-287."""

    def __init__(self, batch_size: int, dataset_size: int,
                 rank: int = 0, world_size: int = 1,
                 lengths: Optional[Sequence[int]] = None,
                 aspect_ratios: Optional[Sequence[int]] = None,
                 num_length_bins: int = 8, drop_last: bool = False,
                 seed: int = 42, verbose: bool = False):
        if lengths is None or aspect_ratios is None:
            raise ValueError(
                "Both 'lengths' and 'aspect_ratios' must be provided")
        if len(lengths) != dataset_size \
                or len(aspect_ratios) != dataset_size:
            raise ValueError(
                "Length of 'lengths'/'aspect_ratios' must match "
                "dataset_size")
        self.batch_size = batch_size
        self.dataset_size = dataset_size
        self.rank = rank
        self.world_size = world_size
        self.lengths = list(lengths)
        self.aspect_ratios = list(aspect_ratios)
        self.num_length_bins = num_length_bins
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.global_batch_size = batch_size * world_size
        self.length_bins = self._create_length_bins()

    def _create_length_bins(self) -> List[int]:
        """Quantile bin boundaries (ref L100-122)."""
        min_len, max_len = min(self.lengths), max(self.lengths)
        if self.num_length_bins <= 1:
            return [min_len, max_len + 1]
        sorted_lengths = sorted(self.lengths)
        bins = [min_len]
        for i in range(1, self.num_length_bins):
            idx = i * len(sorted_lengths) // self.num_length_bins
            bins.append(sorted_lengths[idx])
        bins.append(max_len + 1)
        return bins

    def _get_length_bin(self, length: int) -> int:
        for i in range(len(self.length_bins) - 1):
            if self.length_bins[i] <= length < self.length_bins[i + 1]:
                return i
        return 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.dataset_size // self.world_size

    def _global_batches(self) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)

        buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        for idx in range(self.dataset_size):
            key = (self.aspect_ratios[idx],
                   self._get_length_bin(self.lengths[idx]))
            buckets[key].append(idx)

        global_batches = []
        for key in buckets:
            indices = [buckets[key][i]
                       for i in rng.permutation(len(buckets[key]))]
            if self.drop_last:
                n = len(indices) // self.global_batch_size \
                    * self.global_batch_size
                useful = indices[:n]
            else:
                useful = list(indices)
                rem = len(useful) % self.global_batch_size
                if rem > 0 and useful:
                    pad = self.global_batch_size - rem
                    useful.extend(indices[i % len(indices)]
                                  for i in range(pad))
            for i in range(0, len(useful), self.global_batch_size):
                b = useful[i:i + self.global_batch_size]
                if len(b) == self.global_batch_size:
                    global_batches.append(b)

        order = rng.permutation(len(global_batches))
        return [global_batches[i] for i in order]

    def __iter__(self):
        for gb in self._global_batches():
            start = self.rank * self.batch_size
            yield from gb[start:start + self.batch_size]


class AspectRatioLengthBucketDistributedSampler(
        AspectRatioLengthBucketSampler):
    """Distributed variant (ref L289-355) — same algorithm; rank/world
    passed explicitly (no process-group discovery)."""


class SPAwareAspectRatioLengthBucketDistributedSampler(
        AspectRatioLengthBucketSampler):
    """SP groups are the DP unit (ref L358-490): every rank inside an SP
    group yields identical sample indices."""

    def __init__(self, batch_size: int, dataset_size: int, rank: int,
                 world_size: int, sp_size: int, **kw):
        if world_size % sp_size != 0:
            raise ValueError("world_size must be divisible by sp_size")
        self.sp_size = sp_size
        dp_rank = rank // sp_size
        dp_world = world_size // sp_size
        super().__init__(batch_size, dataset_size, rank=dp_rank,
                         world_size=dp_world, **kw)


class DataLoader:
    """Host-side loader: sampler-driven, batched via collate, with a
    background thread that prefetches ``prefetch`` batches. (The JAX
    package's C++ reader pool comes with ROADMAP queue 1 item 13.)"""

    def __init__(self, dataset, sampler, batch_size: int,
                 collate_fn=latent_collate_function, prefetch: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.prefetch = prefetch

    def _load_batch_items(self, idxs):
        return [self.dataset[i] for i in idxs]

    def __iter__(self):
        import queue
        import threading

        def batches():
            buf = []
            for idx in self.sampler:
                buf.append(idx)
                if len(buf) == self.batch_size:
                    yield self.collate_fn(self._load_batch_items(buf))
                    buf = []

        if self.prefetch <= 0:
            yield from batches()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        errors = []
        stop = threading.Event()  # set when the consumer stops early

        def worker():
            try:
                for b in batches():
                    if stop.is_set():
                        break
                    q.put(b)
            except BaseException as e:  # raised again in the consumer
                errors.append(e)
            finally:
                q.put(sentinel)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if errors:
                        raise errors[0]
                    break
                yield item
        finally:
            # unblock a worker waiting on a full queue, then join it
            stop.set()
            while th.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            th.join()

    def __len__(self):
        return len(self.sampler) // self.batch_size
