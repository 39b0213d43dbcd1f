"""Bicubic image resize, the counterpart of ``jax.image.resize(...,
method="bicubic")``.

The JAX package resizes with ``jax.image.resize`` in two places of the i2v
path: the CLIP input (``models/clip.py::preprocess_frames``, any H × W to
224 × 224) and the conditioning frame (``pipelines/image2video.py::
build_i2v_conditioning``, the image to the request's size). JAX resizes
with the Keys cubic (a = -0.5) over half-pixel centres and, when it
shrinks, widens the kernel by the scale: an antialiased resize. PyTorch's
``F.interpolate(mode="bicubic", align_corners=False, antialias=True)``
computes the same separable filter (within 1e-5 on [-1, 1] images, up and
down); without ``antialias`` a downscale samples the source sparsely and
differs by O(1).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of ``x`` ([..., H, W], float) to ``size`` =
    (H', W') with the antialiased bicubic filter of ``jax.image.resize``.
    Leading axes are kept; the result has ``x``'s dtype."""
    *lead, h, w = x.shape
    flat = x.reshape(-1, 1, h, w).float()
    out = F.interpolate(flat, size=tuple(size), mode="bicubic",
                        align_corners=False, antialias=True)
    return out.reshape(*lead, *size).to(x.dtype)
