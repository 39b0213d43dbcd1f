"""Text→video generation pipeline in PyTorch.

Counterpart of ``moviigen_tpu/pipelines/text2video.py::WanT2V`` (ref
``wan/text2video.py``): umT5 text encoding, the CFG-guided flow-matching
denoise loop around the DiT with UniPC (default) or DPM++, and the causal
3D VAE decode. Everything lives on one device; the 14B DiT (28 GB bf16),
the umT5-XXL encoder (11.6 GB) and the VAE fit one 80 GB card together.
Only a decode that needs over ``FREE_DIT_DECODE_GIB`` does not fit beside
them: ``generate`` then parks the DiT in host memory for the
decode, and the next request brings it back. Weights are random (made from
``init_seed``), read from a checkpoint directory in the reference layout
(``checkpoint_dir``), or carried from a JAX parameter tree with
``convert``.

With a ``mesh`` (a ``parallel.comm.Comm``: ``DistComm`` for one process
per card under ``torchrun``, or a ``ThreadComm`` rank) the pipeline is one
rank of a sequence-parallel group, as the JAX ``WanT2V(mesh=...)`` is:
the umT5 encoder's and the DiT's block weights are held as shards over the
sequence axes and gathered per block, the CFG pair always runs batched
(split over the ``data`` axis), the DiT runs ``sequence_parallel_forward``
in ``sp_mode`` (ulysses | ring | usp) and the token count is rounded up to
a multiple of the sequence-parallel degree. Every rank denoises; rank 0
alone decodes and returns the video (the reference's rule), the others
return None.

``quant`` (int8 | int4 | w8a8) quantizes the DiT's block linears and,
for an encoder above ``_T5_OFFLOAD_BYTES``, the umT5 weight-only. With a
checkpoint directory the quantized trees are cached beside the
checkpoint as safetensors in the JAX package's layout and names, with a
fingerprint of the source files, and later starts load the cache;
prompt embeddings are cached there too. LoRA adapters can be mounted on
the DiT and taken off again (``attach_lora`` / ``detach_lora``; the
validation watcher ``cli/valid_training.py`` renders with them).
"""

from __future__ import annotations

import fnmatch
import hashlib
import logging
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import PipelineConfig
from ..diffusion import (FlowDPMSolverMultistepScheduler,
                         FlowUniPCMultistepScheduler, get_sampling_sigmas)
from ..convert import (load_t5_params, load_wan_params, t5_params_tree,
                       wan_params_tree)
from ..models import vae as vaem
from ..models.t5 import T5Encoder, load_t5_checkpoint
from ..models.tokenizer import load_tokenizer
from ..models.vae_convert import load_vae_checkpoint
from ..models.vae_streaming import decode_streaming, default_chunk_frames
from ..models.wan_convert import SHARD_PATTERN, load_wan_checkpoint
from ..models.wan_model import QUANT_MODES, WanModel
from ..ops.quantization import (load_quantized_checkpoint,
                                quantize_t5_params, quantize_wan_params,
                                read_quantized_metadata,
                                save_quantized_checkpoint)
from ..ops.rope import rope_3d_freqs
from ..parallel.mesh import mesh_axis_size
from ..parallel.sharding import (make_param_gather, shard_axis,
                                 shard_pipeline_params)
from ..parallel.ulysses import SP_MODES, sequence_parallel_forward

# Output pixels (frames × H × W) above which the decode streams over
# latent-frame chunks instead of decoding the clip as one tensor.
STREAMING_DECODE_PIXELS = 2 ** 24

# Device memory the VAE decode takes above what is resident, GiB per 1e6
# output pixels it holds at once (decode_pixels_at_once), for the Wan VAE
# in bf16: one tensor 1.79, streaming 3.93 (a chunk's conv caches, and the
# cache frames concatenated before each conv). tools/vae_decode_memory.py
# on an NVIDIA H100 80GB HBM3 at 700 W, within 2 % over 480p to 1920×1072.
DECODE_GIB_PER_MPX = {"full": 1.79, "stream": 3.93}

# Decode memory (decode_gib) above which generate() parks the DiT in host
# memory before the VAE decode, as the JAX package frees it above its
# FREE_DIT_DECODE_PIXELS (text2video.py:97, 780-787: 40e6 pixels of the
# whole clip, for 16 GB chips) and the reference moves it with
# model.cpu(). The decode's memory follows the pixels it holds at once,
# not the clip's. On the H100 80GB (79.18 GiB usable) t2v-14B, umT5-XXL
# and the VAE keep 38.0 GiB resident, so 41 GiB is free beside them; the
# value keeps 11 GiB of that for the allocator's fragmentation after the
# denoise: the largest decode seen to fit beside the DiT took 28 GiB
# (1280×720×81, before the streaming caches were copies). 1920×832×81
# (25.1 GiB) keeps the DiT, 1920×1072×81 (32.3 GiB) parks it.
# Module-level so tests can lower it.
FREE_DIT_DECODE_GIB = 30.0

# In the quant modes a umT5 whose bf16 weights pass this size is quantized
# weight-only with the DiT (the JAX pipeline's rule, text2video.py:268-272;
# there a smaller encoder also decides host offload, which the port does
# not do). Tests lower it to reach the path at the tiny config.
_T5_OFFLOAD_BYTES = 4 << 30


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when no CUDA device is present and none is
    named: the port does not carry on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' (--device cpu) to run "
                "the port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def decode_streams(t: int, h: int, w: int) -> bool:
    """Whether the decode of T' latent frames to H × W streams."""
    return (1 + (t - 1) * 4) * h * w > STREAMING_DECODE_PIXELS


def decode_pixels_at_once(latent_shape, vae_cfg) -> int:
    """Output pixels one pass of the decode of a latent [..., T', H', W']
    holds: the whole clip when it is decoded as one tensor, else one
    streaming chunk (``default_chunk_frames`` latent frames, 4 output
    frames each)."""
    t, h, w = latent_shape[-3], latent_shape[-2] * 8, latent_shape[-1] * 8
    if not decode_streams(t, h, w):
        return (1 + (t - 1) * 4) * h * w
    return 4 * default_chunk_frames(t, h, w, vae_cfg) * h * w


def decode_gib(latent_shape, vae_cfg) -> float:
    """The decode's device memory above what is resident, GiB, for a
    latent [..., T', H', W'] (DECODE_GIB_PER_MPX of its path)."""
    t, h, w = latent_shape[-3], latent_shape[-2] * 8, latent_shape[-1] * 8
    path = "stream" if decode_streams(t, h, w) else "full"
    return DECODE_GIB_PER_MPX[path] * decode_pixels_at_once(
        latent_shape, vae_cfg) / 1e6


@torch.no_grad()
def decode_video(vae_params, latent: torch.Tensor,
                 config: PipelineConfig) -> torch.Tensor:
    """Latents [B, z, T', H', W'] → video [B, 3, T, H, W], decoded in the
    config's decode dtype and returned as fp32; streams above
    STREAMING_DECODE_PIXELS output pixels."""
    z = latent.to(getattr(torch, config.vae_decode_dtype))
    if decode_streams(z.shape[2], z.shape[3] * 8, z.shape[4] * 8):
        out = decode_streaming(vae_params, z, config.vae)
    else:
        out = vaem.decode(vae_params, z, config.vae)
    return out.float()


def compute_target_shape_and_seq_len(config: PipelineConfig,
                                     size: Tuple[int, int], frame_num: int,
                                     sp_size: int = 1):
    """Latent target shape, token seq_len and patch grid for a (W, H) size
    (ref text2video.py:160-166): 480×832 @ 81f → 32,760 tokens; seq_len
    is rounded up to a multiple of ``sp_size`` (the JAX
    ``compute_target_shape_and_seq_len``)."""
    vs = config.vae_stride
    ps = config.model.patch_size
    target_shape = (config.vae.z_dim, (frame_num - 1) // vs[0] + 1,
                    size[1] // vs[1], size[0] // vs[2])
    seq_len = int(math.ceil((target_shape[2] * target_shape[3])
                            / (ps[1] * ps[2]) * target_shape[1]
                            / sp_size)) * sp_size
    grid = (target_shape[1] // ps[0], target_shape[2] // ps[1],
            target_shape[3] // ps[2])
    return target_shape, seq_len, grid


def cfg_batched(model_dim: int, seq_len: int) -> bool:
    """The JAX pipeline's CFG pairing rule (text2video.py:604): one B=2
    forward while the doubled activations stay small, else cond and
    uncond as two B=1 forwards."""
    return 2 * 2 * seq_len * (3 * model_dim) <= (1 << 30)


class WanT2V:
    """Owns the DiT, the T5 encoder and the VAE on one device and
    generates videos; with a ``mesh``, as one rank of a sequence-parallel
    group."""

    def __init__(self, config: PipelineConfig, init_seed: int = 0,
                 attn_backend: str = "auto",
                 residual_dtype: str = "float32", device=None,
                 checkpoint_dir: Optional[str] = None,
                 quant: Optional[str] = None, prompt_cache: bool = True,
                 mesh=None, sp_mode: str = "ulysses"):
        if sp_mode not in SP_MODES:
            raise ValueError(f"unknown sp_mode: {sp_mode}")
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be int8|int4|w8a8, got {quant!r}")
        if residual_dtype not in ("float32", "bfloat16"):
            raise ValueError("residual_dtype must be float32|bfloat16, "
                             f"got {residual_dtype!r}")
        self.device = resolve_device(device)
        self.config = config
        self.quant = quant
        self.attn_backend = attn_backend
        self.residual_dtype = getattr(torch, residual_dtype)
        self.sample_neg_prompt = config.sample_neg_prompt
        self.timings = {}
        self.mesh = mesh
        self.sp_mode = sp_mode
        self.sp_size = mesh_axis_size(mesh, "ring") * mesh_axis_size(
            mesh, "seq")

        tc = config.t5
        t5_bytes = 2 * (tc.vocab_size * tc.dim + tc.num_layers * (
            3 * tc.dim * tc.dim_attn + tc.dim_attn * tc.dim
            + 3 * tc.dim * tc.dim_ffn))
        self._quant_t5 = quant is not None and t5_bytes > _T5_OFFLOAD_BYTES
        t5_bits = (4 if quant == "int4" else 8) if self._quant_t5 else None
        t5_dtype = getattr(torch, config.t5_dtype)
        dtype = config.torch_param_dtype
        dev = self.device

        with torch.no_grad():
            if checkpoint_dir is not None:
                self._load_checkpoint(checkpoint_dir, t5_bits, t5_dtype, dtype)
                tok_path = os.path.join(checkpoint_dir, config.t5_tokenizer)
            else:
                logging.warning("no checkpoint_dir: random-init params from "
                                "seed %d", init_seed)
                gen = torch.Generator(device=dev).manual_seed(init_seed)
                self.t5 = T5Encoder(config.t5, dtype=t5_dtype, device=dev,
                                    quant_bits=t5_bits).init_weights(gen)
                # the encoder too where requests encode (i2v); a t2v
                # pipeline only decodes
                self.vae_params = vaem.init_params(
                    config.vae, gen, device=dev,
                    encoder=config.model.model_type == "i2v")
                self.dit = WanModel(config.model, dtype=dtype, device=dev,
                                    quant=quant).init_weights(gen)
                tok_path = config.t5_tokenizer
        self.t5.eval()
        self.dit.eval()
        self._gather = None
        if mesh is not None:
            # the JAX shard_pipeline_params: the models now hold this
            # rank's shards; the full weights go with the old modules
            self.t5, self.vae_params, self.dit = shard_pipeline_params(
                mesh, self.t5, self.vae_params, self.dit)
            self._gather = make_param_gather(mesh, shard_axis(mesh))
        self.dit_parked = False  # the DiT is in host memory (generate())
        self.tokenizer = load_tokenizer(
            tok_path, seq_len=config.model.text_len,
            clean="whitespace", vocab_size=config.t5.vocab_size)

        # Prompt-embedding cache beside the checkpoint: repeated prompts
        # (validation sets, retries, the CFG negative prompt) skip the
        # encoder.
        # Under a mesh the encoder's weight gathers are collective, so
        # every rank encodes every prompt and no rank may skip the encoder
        # on a cache hit: the cache is off there.
        self._prompt_cache_dir = None
        if prompt_cache and checkpoint_dir is not None and mesh is None:
            self._prompt_cache_dir = os.path.join(
                checkpoint_dir, "moviigen_prompt_cache")
            t5_src = os.path.join(checkpoint_dir, config.t5_checkpoint)
            self._prompt_cache_tag = (
                f"{self._source_fingerprint([t5_src])};"
                f"quant={quant if self._quant_t5 else None};"
                f"len={config.model.text_len};"
                f"tok={type(self.tokenizer).__name__}")

    def attach_lora(self, adapters, alpha: float = 64.0,
                    rank: int = 64) -> None:
        """Mount LoRA adapters (``training/lora.py``) on the DiT, moved to
        its device: every later request runs their side path after each
        targeted linear, under any ``quant`` (W8A8 after the int8 GEMM)."""
        from ..training.lora import attach_lora

        for ad in adapters.values():
            ad.to(self.device)
        attach_lora(self.dit, adapters, alpha=alpha, rank=rank)

    def detach_lora(self):
        """Take the adapters off the DiT; returns them. The DiT is then
        the base it was, bit for bit."""
        from ..training.lora import detach_lora

        return detach_lora(self.dit)

    def _load_checkpoint(self, checkpoint_dir, t5_bits, t5_dtype, dtype):
        """The three models from a checkpoint directory in the reference
        layout; quantized ones through their cache."""
        config, quant, dev = self.config, self.quant, self.device
        logging.info("loading checkpoints from %s", checkpoint_dir)
        t5_path = os.path.join(checkpoint_dir, config.t5_checkpoint)
        if t5_bits is not None:
            tree = self._quantized_with_cache(
                checkpoint_dir, f"t5_{quant}",
                lambda: t5_params_tree(quantize_t5_params(
                    load_t5_checkpoint(t5_path, config.t5, t5_dtype, dev),
                    bits=t5_bits)),
                sources=[t5_path], device=dev)
            self.t5 = load_t5_params(
                T5Encoder(config.t5, dtype=t5_dtype, device=dev,
                          quant_bits=t5_bits), tree)
        else:
            self.t5 = load_t5_checkpoint(t5_path, config.t5, t5_dtype, dev)
        self.vae_params = load_vae_checkpoint(
            os.path.join(checkpoint_dir, config.vae_checkpoint), config.vae,
            torch.float32, dev)
        if quant is None:
            self.dit = load_wan_checkpoint(checkpoint_dir, config.model,
                                           dtype, dev)
            return
        # quantize once (the full-precision DiT is loaded to the device and
        # quantized there, one linear at a time), cache the compact tree
        # beside the checkpoint; later starts read only the cache
        shards = [os.path.join(checkpoint_dir, f)
                  for f in os.listdir(checkpoint_dir)
                  if fnmatch.fnmatch(f, SHARD_PATTERN)]
        tree = self._quantized_with_cache(
            checkpoint_dir, f"dit_{quant}",
            lambda: wan_params_tree(quantize_wan_params(
                load_wan_checkpoint(checkpoint_dir, config.model, dtype, dev),
                bits=4 if quant == "int4" else 8, act8=quant == "w8a8")),
            sources=shards, device=dev)
        self.dit = load_wan_params(
            WanModel(config.model, dtype=dtype, device=dev, quant=quant),
            tree)

    @staticmethod
    def _source_fingerprint(sources) -> str:
        """Cheap identity of the full-precision source files: name, byte
        size and mtime of each (no content hash: a 28 GB read per start
        would defeat the cache)."""
        parts = []
        for s in sorted(sources):
            try:
                st = os.stat(s)
                parts.append(
                    f"{os.path.basename(s)}:{st.st_size}:{st.st_mtime_ns}")
            except OSError:
                parts.append(f"{os.path.basename(s)}:missing")
        return ";".join(parts)

    @staticmethod
    def _quantized_with_cache(checkpoint_dir: str, tag: str, build,
                              sources=(), device=None):
        """The cached quantized tree ``moviigen_quant_<tag>.safetensors``
        beside the checkpoint, or ``build()`` and cache it. The cache's
        header records a fingerprint of the source files; on a mismatch
        the stale cache is rebuilt, not served. A cache that cannot be
        written (read-only directory) costs a quantization per start."""
        cache = os.path.join(checkpoint_dir,
                             f"moviigen_quant_{tag}.safetensors")
        fp = WanT2V._source_fingerprint(sources)
        if os.path.exists(cache):
            try:
                meta = read_quantized_metadata(cache)
            except (OSError, ValueError):  # unreadable header: stale
                meta = {}
            if meta.get("source_fingerprint", fp) == fp:
                logging.info("loading quantized cache %s", cache)
                return load_quantized_checkpoint(cache, device)
            logging.warning("quantized cache %s is stale (source checkpoint "
                            "changed); rebuilding", cache)
        tree = build()
        try:
            save_quantized_checkpoint(
                cache, tree, metadata={"source_fingerprint": fp, "tag": tag})
            logging.info("wrote quantized cache %s", cache)
        except OSError as e:  # the cache is best-effort
            logging.warning("could not write quantized cache: %s", e)
        return tree

    # ------------------------------------------------------------------

    def _prompt_cache_path(self, text: str) -> Optional[str]:
        if self._prompt_cache_dir is None:
            return None
        h = hashlib.sha256(
            f"{self._prompt_cache_tag}\x00{text}".encode()).hexdigest()
        return os.path.join(self._prompt_cache_dir, f"{h[:32]}.npz")

    @torch.no_grad()
    def encode_text(self, texts) -> torch.Tensor:
        """Prompt(s) → [B, text_len, t5_dim], exact zeros past each true
        length (ref t5.py:516-518 + model.py:549-554). With a checkpoint
        directory the embeddings are cached there per (prompt, T5 file
        fingerprint, quant mode); a hit on the whole batch skips the
        encoder."""
        if isinstance(texts, str):
            texts = [texts]
        paths = [self._prompt_cache_path(t) for t in texts]
        if all(p is not None and os.path.exists(p) for p in paths):
            loaded = [np.load(p) for p in paths]
            logging.info("prompt-embedding cache hit (%d prompt(s))",
                         len(loaded))
            ctx = torch.from_numpy(np.stack([z["ctx"] for z in loaded]))
            return ctx.to(self.device, getattr(torch, str(loaded[0]["dtype"])))
        ctx = self._encode_text_uncached(texts)
        if self._prompt_cache_dir is not None:
            try:
                os.makedirs(self._prompt_cache_dir, exist_ok=True)
                host = ctx.float().cpu().numpy()  # bf16 → fp32 is exact
                for p, row in zip(paths, host):
                    np.savez(p, ctx=row,
                             dtype=str(ctx.dtype).replace("torch.", ""))
            except OSError as e:  # read-only checkpoint dir: best-effort
                logging.warning("could not write prompt cache: %s", e)
        return ctx

    def _encode_text_uncached(self, texts) -> torch.Tensor:
        ids, mask = self.tokenizer(texts, return_mask=True,
                                   add_special_tokens=True)
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                              device=self.device)
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.long,
                               device=self.device)
        ids, mask = self._from_rank0(ids), self._from_rank0(mask)
        ctx = self.t5(ids, mask, param_gather_fn=self._gather)
        return ctx * mask[..., None].to(ctx.dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """Latents [B, z, T', H', W'] → video [B, 3, T, H, W] fp32
        (``decode_video``)."""
        return decode_video(self.vae_params, latent, self.config)

    @torch.no_grad()
    def generate(self, input_prompt: str,
                 size: Tuple[int, int] = (1280, 720),
                 frame_num: int = 81,
                 shift: float = 5.0,
                 sample_solver: str = "unipc",
                 sampling_steps: int = 50,
                 guide_scale: float = 5.0,
                 n_prompt: str = "",
                 seed: int = -1,
                 noise: Optional[np.ndarray] = None,
                 return_latents: bool = False) -> Optional[np.ndarray]:
        """Generate a video (ref WanT2V.generate, text2video.py:114-271).

        Returns [C, F, H, W] numpy float32 in [-1, 1], or the final latent
        [z, F', H', W'] with ``return_latents``. ``noise`` replaces the
        seeded initial latent. Under a mesh every rank returns the latent,
        and only rank 0 the video (the others None). Per-phase seconds land in ``self.timings``
        (t5_s, step_s list, decode_s; dit_unpark_s when the previous
        request parked the DiT, dit_park_s when this one does)."""
        ctx_pair = self._start_request(input_prompt, n_prompt)
        latent = self._sample(ctx_pair, size, frame_num, shift,
                              sample_solver, sampling_steps, guide_scale,
                              seed, noise)
        if return_latents:
            return latent[0].cpu().numpy()
        return self.decode_request(latent)

    @property
    def is_output_rank(self) -> bool:
        """Whether this pipeline decodes and returns the video: always
        without a mesh, else on rank 0 alone."""
        return self.mesh is None or self.mesh.rank == 0

    def _from_rank0(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank of the mesh (``x`` itself without
        one): what each rank draws or tokenizes on its own (a seed < 0; the
        hash tokenizer's ids, salted per process) must agree."""
        if self.mesh is None:
            return x
        n = x.shape[0]
        x = self.mesh.all_gather(x, shard_axis(self.mesh), 0)[:n]
        return self.mesh.all_gather(x, "data", 0)[:n]

    def _start_request(self, input_prompt: str, n_prompt: str):
        """A request's first stage: fresh ``self.timings``, the DiT back on
        the device, the prompt and the negative prompt encoded (t5_s).
        Returns the context pair [2, text_len, t5_dim]."""
        if n_prompt == "":
            n_prompt = self.sample_neg_prompt
        self.timings = {"step_s": []}
        self.unpark_dit()
        t0 = time.perf_counter()
        ctx_pair = self.encode_text([input_prompt, n_prompt])
        self._sync()
        self.timings["t5_s"] = time.perf_counter() - t0
        return ctx_pair

    def _sample(self, ctx_pair, size, frame_num, shift, sample_solver,
                sampling_steps, guide_scale, seed, noise, **cond):
        """The CFG-guided denoise loop from the seeded (or given) noise;
        returns the final latent [1, z, F', H', W'] (step_s). ``cond``:
        further per-sample DiT inputs (the i2v ``clip_fea`` [1, ...] and
        ``y`` [1, ...]), repeated for the batched CFG pair."""
        cfg = self.config
        target_shape, seq_len, grid = compute_target_shape_and_seq_len(
            cfg, size, frame_num, self.sp_size)
        if seed < 0:
            seed = int.from_bytes(os.urandom(4), "little")
        seed = int(self._from_rank0(torch.tensor(
            [seed], dtype=torch.int64, device=self.device))[0])
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            latent = torch.randn((1, *target_shape), generator=gen,
                                 dtype=torch.float32, device=self.device)
        else:
            latent = torch.as_tensor(np.asarray(noise, np.float32),
                                     device=self.device).reshape(
                                         1, *target_shape)

        if sample_solver == "unipc":
            scheduler = FlowUniPCMultistepScheduler(
                num_train_timesteps=cfg.num_train_timesteps, shift=1.0)
            scheduler.set_timesteps(sampling_steps, shift=shift)
        elif sample_solver == "dpm++":
            scheduler = FlowDPMSolverMultistepScheduler(
                num_train_timesteps=cfg.num_train_timesteps, shift=1.0)
            scheduler.set_timesteps(
                sampling_steps,
                sigmas=get_sampling_sigmas(sampling_steps, shift))
        else:
            raise NotImplementedError(f"Unsupported solver: {sample_solver}")

        rope = rope_3d_freqs(grid, cfg.model.head_dim, device=self.device)
        # under a mesh the tokens are sharded and the pair is split over
        # 'data': it stays batched (the JAX rule, text2video.py:604)
        use_sp = self.mesh is not None
        batched = use_sp or cfg_batched(cfg.model.dim, seq_len)
        cond2 = {k: v.expand(2, *v.shape[1:]) for k, v in cond.items()}

        def fwd(x, t, ctx, extra):
            if use_sp:
                return sequence_parallel_forward(
                    self.dit, x, t, ctx, rope, self.mesh, seq_len=seq_len,
                    attn_backend=self.attn_backend, sp_mode=self.sp_mode,
                    fsdp_params=True, residual_dtype=self.residual_dtype,
                    **extra)
            return self.dit(x, t, ctx, rope, seq_len=seq_len,
                            attn_backend=self.attn_backend,
                            residual_dtype=self.residual_dtype, **extra)

        logging.info("denoising: %d %s steps at %d tokens (%s CFG%s)",
                     sampling_steps, sample_solver, seq_len,
                     "batched" if batched else "sequential",
                     f", {self.sp_mode} over {self.sp_size} ranks"
                     if use_sp else "")
        state = scheduler.init_state(latent)
        for i, t in enumerate(scheduler.timesteps):
            ts = time.perf_counter()
            t_dev = torch.full((1,), float(t), dtype=torch.float32,
                               device=self.device)
            if batched:
                pred = fwd(latent.expand(2, *target_shape), t_dev.expand(2),
                           ctx_pair, cond2)
                cond_pred, uncond = pred[:1], pred[1:]
            else:
                cond_pred = fwd(latent, t_dev, ctx_pair[:1], cond)
                uncond = fwd(latent, t_dev, ctx_pair[1:], cond)
            noise_pred = uncond + guide_scale * (cond_pred - uncond)
            latent, state = scheduler.step(noise_pred, i, latent, state)
            self._sync()
            self.timings["step_s"].append(time.perf_counter() - ts)
        return latent

    def unpark_dit(self) -> None:
        """Move a DiT parked by the last decode back to the device
        (dit_unpark_s in ``self.timings``); nothing when it is there."""
        if not self.dit_parked:
            return
        t0 = time.perf_counter()
        self.dit.to(self.device)
        self.dit_parked = False
        self._sync()
        self.timings["dit_unpark_s"] = time.perf_counter() - t0

    def decode_request(self, latent: torch.Tensor) -> Optional[np.ndarray]:
        """A request's last stage: park the DiT when the decode needs over
        FREE_DIT_DECODE_GIB (``decode_gib``), then decode
        ``latent`` [1, z, T', H', W'] → [C, F, H, W] numpy; dit_park_s and
        decode_s land in ``self.timings``. Under a mesh only rank 0
        decodes (the others return None) and the DiT, held as shards,
        stays (the JAX pipeline frees it only without a mesh)."""
        if not self.is_output_rank:
            return None
        if self.mesh is None and decode_gib(
                latent.shape, self.config.vae) > FREE_DIT_DECODE_GIB:
            t0 = time.perf_counter()
            self.dit.to("cpu")  # gives its device memory back to the cache
            self.dit_parked = True
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self.timings["dit_park_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        video = self.decode(latent)
        self._sync()
        self.timings["decode_s"] = time.perf_counter() - t0
        return video[0].cpu().numpy()
