"""Model / pipeline configuration registry.

The port's own copy of ``moviigen_tpu/configs/__init__.py``: the same
frozen dataclasses, registries and ``__post_init__`` checks, with a
``torch`` dtype property in place of ``jnp_param_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

ATTN_BACKENDS = ("auto", "plain")


@dataclasses.dataclass(frozen=True)
class WanModelConfig:
    """DiT backbone hyperparameters (ref: wan/modules/model.py:372-442)."""

    model_type: str = "t2v"  # 't2v' | 'i2v'
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    window_size: Tuple[int, int] = (-1, -1)
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    # Memory knobs of the JAX package (token / head chunking of the FFN,
    # self- and cross-attention, streamed o-projection, training-side
    # chunks). They do not change the maths; one 80 GB card runs the
    # 480p/720p shapes without them, so the port's forward raises
    # NotImplementedError when one is set. Kept so configs stay
    # interchangeable with the JAX registry.
    ffn_chunk: Optional[int] = None
    attn_head_chunk: Optional[int] = None
    cross_attn_chunk: Optional[int] = None
    attn_o_stream: bool = True
    attn_o_chunk: Optional[int] = None
    ffn_bwd_chunk: Optional[int] = None
    attn_bwd_chunk: Optional[int] = None
    stream_impl: str = "fori"
    # attention backend for cross-attention only (None = the call site's)
    cross_attn_backend: Optional[str] = None

    def __post_init__(self):
        """The JAX package's validation of contradictory knob settings
        (configs/__init__.py:111-165), kept as is."""
        if self.model_type not in ("t2v", "i2v"):
            raise ValueError(f"model_type {self.model_type!r} not in "
                             "('t2v', 'i2v')")
        if self.stream_impl not in ("fori", "unroll"):
            raise ValueError(f"stream_impl {self.stream_impl!r} not in "
                             "('fori', 'unroll')")
        if self.cross_attn_backend not in (None, *ATTN_BACKENDS):
            raise ValueError(
                f"cross_attn_backend {self.cross_attn_backend!r} not in "
                f"{(None, *ATTN_BACKENDS)}")
        for knob in self.memory_knobs():
            val = getattr(self, knob)
            if val is not None and val <= 0:
                raise ValueError(f"{knob} must be positive, got {val}")
        if self.attn_head_chunk is not None \
                and self.num_heads % self.attn_head_chunk != 0:
            raise ValueError(
                f"attn_head_chunk {self.attn_head_chunk} must divide "
                f"num_heads {self.num_heads}")
        if self.attn_o_chunk is not None and (
                self.attn_head_chunk is None or not self.attn_o_stream):
            raise ValueError(
                "attn_o_chunk token-chunks the STREAMED o-projection: it "
                "requires attn_head_chunk set and attn_o_stream=True")
        if self.attn_bwd_chunk is not None \
                and self.attn_head_chunk is not None:
            raise ValueError(
                "attn_bwd_chunk (training-side q-chunked self-attention) "
                "and attn_head_chunk (serving-side streamed attention) "
                "are mutually exclusive")
        if self.ffn_bwd_chunk is not None and self.ffn_chunk is not None:
            raise ValueError(
                "ffn_chunk (forward-only FFN stream) and ffn_bwd_chunk "
                "(training-side FFN chunks) are mutually exclusive")

    @staticmethod
    def memory_knobs() -> Tuple[str, ...]:
        return ("ffn_chunk", "attn_head_chunk", "cross_attn_chunk",
                "attn_o_chunk", "ffn_bwd_chunk", "attn_bwd_chunk")

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def replace(self, **kw) -> "WanModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """3D causal VAE hyperparameters (ref: wan/modules/vae.py:592-616)."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temporal_downsample: Tuple[bool, ...] = (False, True, True)

    def replace(self, **kw) -> "VAEConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """umT5-XXL encoder hyperparameters (ref: wan/modules/t5.py:456-469)."""

    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim_attn // self.num_heads

    def replace(self, **kw) -> "T5Config":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level task config (ref: wan/configs/shared_config.py +
    wan_t2v_14B.py)."""

    name: str = "t2v-14B"
    model: WanModelConfig = dataclasses.field(default_factory=WanModelConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    vae_stride: Tuple[int, int, int] = (4, 8, 8)
    num_train_timesteps: int = 1000
    sample_fps: int = 16
    param_dtype: str = "bfloat16"
    t5_dtype: str = "bfloat16"
    # VAE decode compute dtype ("float32" for bit-parity work)
    vae_decode_dtype: str = "bfloat16"
    # checkpoint file conventions within --ckpt_dir (parity with reference)
    t5_checkpoint: str = "models_t5_umt5-xxl-enc-bf16.pth"
    t5_tokenizer: str = "google/umt5-xxl"
    vae_checkpoint: str = "Wan2.1_VAE.pth"
    # default negative prompt (ref: wan/configs/shared_config.py:19)
    sample_neg_prompt: str = (
        "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，"
        "整体发灰，最差质量，低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，"
        "画得不好的手部，画得不好的脸部，畸形的，毁容的，形态畸形的肢体，手指融合，"
        "静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
    )

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def _t2v_14b() -> PipelineConfig:
    # ref: wan/configs/wan_t2v_14B.py:19-29
    return PipelineConfig(
        name="t2v-14B",
        model=WanModelConfig(
            model_type="t2v", patch_size=(1, 2, 2), dim=5120,
            ffn_dim=13824, freq_dim=256, num_heads=40, num_layers=40,
            qk_norm=True, cross_attn_norm=True, eps=1e-6),
    )


def _t2v_1_3b() -> PipelineConfig:
    # Wan2.1 1.3B shape (public Wan2.1 family config)
    return PipelineConfig(
        name="t2v-1.3B",
        model=WanModelConfig(
            model_type="t2v", patch_size=(1, 2, 2), dim=1536,
            ffn_dim=8960, freq_dim=256, num_heads=12, num_layers=30,
            qk_norm=True, cross_attn_norm=True, eps=1e-6),
    )


def _tiny_test() -> PipelineConfig:
    """Miniature config for unit tests — same structure, trivial sizes."""
    return PipelineConfig(
        name="t2v-tiny",
        model=WanModelConfig(
            model_type="t2v", patch_size=(1, 2, 2), text_len=16, in_dim=4,
            dim=96, ffn_dim=192, freq_dim=32, text_dim=32, out_dim=4,
            num_heads=4, num_layers=2),
        vae=VAEConfig(dim=8, z_dim=4),
        t5=T5Config(vocab_size=128, dim=32, dim_attn=32, dim_ffn=64,
                    num_heads=4, num_layers=2),
    )


def _i2v_14b() -> PipelineConfig:
    """i2v model variant (Wan2.1 family): in_dim = z + mask(4) + z = 36."""
    base = _t2v_14b()
    return base.replace(
        name="i2v-14B", model=base.model.replace(model_type="i2v", in_dim=36))


def _i2v_tiny() -> PipelineConfig:
    base = _tiny_test()
    return base.replace(
        name="i2v-tiny", model=base.model.replace(model_type="i2v", in_dim=12))


WAN_CONFIGS = {
    "t2v-14B": _t2v_14b(),
    "t2i-14B": dataclasses.replace(_t2v_14b(), name="t2i-14B"),
    "i2v-14B": _i2v_14b(),
    "t2v-1.3B": _t2v_1_3b(),
    "t2v-tiny": _tiny_test(),
    "i2v-tiny": _i2v_tiny(),
}

# ref: wan/configs/__init__.py:18-31
SIZE_CONFIGS = {
    "1920*1056": (1920, 1056),
    "1920*1072": (1920, 1072),
    "1920*832": (1920, 832),
    "1280*560": (1280, 560),
    "560*1280": (560, 1280),
    "1056*1920": (1056, 1920),
    "832*1920": (832, 1920),
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
    "1024*1024": (1024, 1024),
}

# ref: wan/configs/__init__.py:33-38
MAX_AREA_CONFIGS = {
    "720*1280": 720 * 1280,
    "1280*720": 1280 * 720,
    "480*832": 480 * 832,
    "832*480": 832 * 480,
}

# ref: wan/configs/__init__.py:40-43
SUPPORTED_SIZES = {
    "t2v-14B": (
        "720*1280", "1280*720", "480*832", "832*480", "1920*1056",
        "1056*1920", "1920*832", "832*1920", "1920*1072", "1072*1920",
        "1280*560", "560*1280",
    ),
    "t2v-1.3B": ("480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2v-tiny": tuple(SIZE_CONFIGS.keys()),
    "i2v-tiny": tuple(SIZE_CONFIGS.keys()),
    "t2i-14B": tuple(SIZE_CONFIGS.keys()),
}
