"""Video transform zoo — the port's own copy of
``moviigen_tpu/data/transforms.py``, the parity surface of the
reference's ``scripts/dataset/transform.py`` (611 LoC), numpy-native.

The reference zoo operates on torch ``[T, C, H, W]`` tensors; this data
layer is host-side numpy (+ cv2 for resampling), so these transforms
take ``[T, C, H, W]`` numpy arrays and return the same layout. Semantics
per function cite the reference:

- ``crop``/``resize``/``resize_scale``/``resized_crop``
  (transform.py:35-88), ``center_crop`` (L91-101),
  ``center_crop_using_short_edge`` (L104-116), ``center_crop_th_tw``
  (L119-136 — minus the live ``breakpoint()`` at L133),
  ``random_shift_crop`` (L139-156), ``normalize_video`` (L159-172),
  ``normalize`` (L175-192), ``hflip`` (L195-204).
- Classes ``RandomCropVideo`` (L207-242), ``SpatialStrideCropVideo``
  (L245-269), ``LongSideResizeVideo`` (L272-309),
  ``CenterCropResizeVideo`` (L312-351 — reference's ``__call__`` is
  dead code with two breakpoints; the working semantics are
  center_crop_th_tw → resize), ``UCFCenterCropVideo`` (L354-387),
  ``KineticsRandomCropResizeVideo`` (L390-412), ``CenterCropVideo``
  (L415-443), ``Normalize`` (L446-468), ``Normalize255`` (L471-489),
  ``RandomHorizontalFlipVideo`` (L492-514), ``TemporalRandomCrop``
  (L520-534), ``DynamicSampleDuration`` (L537-555).

Resampling: the reference uses ``torch.nn.functional.interpolate``
(bilinear, align_corners=True, antialias=True); here cv2's INTER_LINEAR
(upscale) / INTER_AREA (downscale) stand in — not bit-identical, but
pixel-equivalent for training purposes (parity tests bound the delta).
Geometry (crop boxes, flip, normalize) is exact.
"""

import numbers
import random
from typing import Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is baked into the image
    cv2 = None

__all__ = [
    "crop", "resize", "resize_scale", "resized_crop", "center_crop",
    "center_crop_using_short_edge", "center_crop_th_tw",
    "random_shift_crop", "normalize_video", "normalize", "hflip",
    "RandomCropVideo", "SpatialStrideCropVideo", "LongSideResizeVideo",
    "CenterCropResizeVideo", "UCFCenterCropVideo",
    "KineticsRandomCropResizeVideo", "CenterCropVideo", "Normalize",
    "Normalize255", "RandomHorizontalFlipVideo", "TemporalRandomCrop",
    "DynamicSampleDuration", "Compose",
]


def _check_clip(clip: np.ndarray) -> None:
    if not isinstance(clip, np.ndarray):
        raise TypeError(f"clip should be ndarray. Got {type(clip)}")
    if clip.ndim != 4:
        raise ValueError(f"clip should be 4D [T,C,H,W]. Got {clip.ndim}D")


def crop(clip: np.ndarray, i: int, j: int, h: int, w: int) -> np.ndarray:
    """Spatial crop of a [T, C, H, W] clip (ref transform.py:35-42)."""
    _check_clip(clip)
    return clip[..., i:i + h, j:j + w]


def _resize_frame(frame_hwc: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w = frame_hwc.shape[:2]
    # INTER_AREA for shrinking approximates the reference's antialiased
    # bilinear; INTER_LINEAR for enlarging matches plain bilinear.
    interp = cv2.INTER_AREA if (th < h or tw < w) else cv2.INTER_LINEAR
    return cv2.resize(frame_hwc, (tw, th), interpolation=interp)


def resize(clip: np.ndarray, target_size: Sequence[int],
           interpolation_mode: str = "bilinear") -> np.ndarray:
    """Resize to (H, W) (ref transform.py:45-54). Output is float32 if
    the input was floating, else uint8."""
    if len(target_size) != 2:
        raise ValueError("target size should be tuple (height, width), "
                         f"instead got {target_size}")
    _check_clip(clip)
    th, tw = int(target_size[0]), int(target_size[1])
    floating = np.issubdtype(clip.dtype, np.floating)
    out = np.empty(clip.shape[:2] + (th, tw),
                   np.float32 if floating else clip.dtype)
    src = clip.astype(np.float32) if floating else clip
    for t in range(clip.shape[0]):
        frame = np.moveaxis(src[t], 0, -1)  # CHW → HWC for cv2
        out[t] = np.moveaxis(_resize_frame(frame, th, tw), -1, 0)
    return out


def resize_scale(clip: np.ndarray, target_size: Sequence[int],
                 interpolation_mode: str = "bilinear") -> np.ndarray:
    """Scale so the SHORT edge reaches target_size[0]
    (ref transform.py:57-68: scale = target[0]/min(H, W))."""
    if len(target_size) != 2:
        raise ValueError("target size should be tuple (height, width), "
                         f"instead got {target_size}")
    h, w = clip.shape[-2], clip.shape[-1]
    scale = target_size[0] / min(h, w)
    return resize(clip, (int(h * scale), int(w * scale)),
                  interpolation_mode)


def resized_crop(clip: np.ndarray, i: int, j: int, h: int, w: int,
                 size: Sequence[int],
                 interpolation_mode: str = "bilinear") -> np.ndarray:
    """Crop then resize (ref transform.py:71-88)."""
    return resize(crop(clip, i, j, h, w), size, interpolation_mode)


def center_crop(clip: np.ndarray,
                crop_size: Sequence[int]) -> np.ndarray:
    """Center crop to (th, tw); errors if smaller
    (ref transform.py:91-101)."""
    _check_clip(clip)
    h, w = clip.shape[-2], clip.shape[-1]
    th, tw = crop_size
    if h < th or w < tw:
        raise ValueError(
            "height and width must be no smaller than crop_size")
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return crop(clip, i, j, th, tw)


def center_crop_using_short_edge(clip: np.ndarray) -> np.ndarray:
    """Square center crop at the short edge (ref transform.py:104-116)."""
    _check_clip(clip)
    h, w = clip.shape[-2], clip.shape[-1]
    if h < w:
        th, tw, i, j = h, h, 0, int(round((w - h) / 2.0))
    else:
        th, tw, i, j = w, w, int(round((h - w) / 2.0)), 0
    return crop(clip, i, j, th, tw)


def center_crop_th_tw(clip: np.ndarray, th: int, tw: int,
                      top_crop: bool = False) -> np.ndarray:
    """Crop to the largest window with aspect th/tw; vertical position
    top or center (ref transform.py:119-136, minus its live
    ``breakpoint()``)."""
    _check_clip(clip)
    h, w = clip.shape[-2], clip.shape[-1]
    tr = th / tw
    if h / w > tr:
        new_h, new_w = int(w * tr), w
    else:
        new_h, new_w = h, int(h / tr)
    i = 0 if top_crop else int(round((h - new_h) / 2.0))
    j = int(round((w - new_w) / 2.0))
    return crop(clip, i, j, new_h, new_w)


def random_shift_crop(
        clip: np.ndarray,
        rng: Optional[random.Random] = None) -> np.ndarray:
    """Square crop at the short edge, random position along both axes
    (ref transform.py:139-156)."""
    _check_clip(clip)
    r = rng or random
    h, w = clip.shape[-2], clip.shape[-1]
    se = min(h, w)
    i = r.randint(0, h - se)
    j = r.randint(0, w - se)
    return crop(clip, i, j, se, se)


def normalize_video(clip: np.ndarray) -> np.ndarray:
    """uint8 → float32 / 255 (ref transform.py:159-172)."""
    _check_clip(clip)
    if clip.dtype != np.uint8:
        raise TypeError("clip tensor should have data type uint8. "
                        f"Got {clip.dtype}")
    return clip.astype(np.float32) / 255.0


def normalize(clip: np.ndarray, mean, std,
              inplace: bool = False) -> np.ndarray:
    """Mean/std normalization broadcast along axis 0 — the clip must be
    channel-first ``[C, T, H, W]`` (ref transform.py:175-192 broadcasts
    ``mean[:, None, None, None]``; the Normalize class docstring at
    L463 documents the (C, T, H, W) layout)."""
    _check_clip(clip)
    if not inplace:
        clip = clip.copy()
    mean = np.asarray(mean, clip.dtype).reshape(-1, 1, 1, 1)
    std = np.asarray(std, clip.dtype).reshape(-1, 1, 1, 1)
    clip -= mean
    clip /= std
    return clip


def hflip(clip: np.ndarray) -> np.ndarray:
    """Flip along width (ref transform.py:195-204)."""
    _check_clip(clip)
    return clip[..., ::-1]


class Compose:
    """Chain transforms (stands in for torchvision.transforms.Compose,
    used in the reference pipeline at scripts/dataset/__init__.py:10-39)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"{self.__class__.__name__}([{inner}])"


class RandomCropVideo:
    """Random fixed-size crop (ref transform.py:207-242)."""

    def __init__(self, size, rng: Optional[random.Random] = None):
        if isinstance(size, numbers.Number):
            self.size = (int(size), int(size))
        else:
            self.size = tuple(size)
        self.rng = rng or random

    def get_params(self, clip) -> Tuple[int, int, int, int]:
        h, w = clip.shape[-2:]
        th, tw = self.size
        if h < th or w < tw:
            raise ValueError(f"Required crop size {(th, tw)} is larger "
                             f"than input image size {(h, w)}")
        if w == tw and h == th:
            return 0, 0, h, w
        return (self.rng.randint(0, h - th),
                self.rng.randint(0, w - tw), th, tw)

    def __call__(self, clip):
        i, j, h, w = self.get_params(clip)
        return crop(clip, i, j, h, w)

    def __repr__(self):
        return f"{self.__class__.__name__}(size={self.size})"


class SpatialStrideCropVideo:
    """Top-left crop to the largest stride-multiple size
    (ref transform.py:245-269)."""

    def __init__(self, stride: int):
        self.stride = stride

    def get_params(self, clip) -> Tuple[int, int, int, int]:
        h, w = clip.shape[-2:]
        s = self.stride
        return 0, 0, h // s * s, w // s * s

    def __call__(self, clip):
        i, j, h, w = self.get_params(clip)
        return crop(clip, i, j, h, w)

    def __repr__(self):
        return f"{self.__class__.__name__}(stride={self.stride})"


class LongSideResizeVideo:
    """Resize so the LONG edge equals ``size``
    (ref transform.py:272-309)."""

    def __init__(self, size: int, skip_low_resolution: bool = False,
                 interpolation_mode: str = "bilinear"):
        self.size = size
        self.skip_low_resolution = skip_low_resolution
        self.interpolation_mode = interpolation_mode

    def __call__(self, clip):
        h, w = clip.shape[-2], clip.shape[-1]
        if self.skip_low_resolution and max(h, w) <= self.size:
            return clip
        if h > w:
            h, w = self.size, int(w * self.size / h)
        else:
            h, w = int(h * self.size / w), self.size
        return resize(clip, (h, w), self.interpolation_mode)

    def __repr__(self):
        return (f"{self.__class__.__name__}(size={self.size}, "
                f"interpolation_mode={self.interpolation_mode})")


class CenterCropResizeVideo:
    """Aspect-preserving center crop to size's aspect, then resize to
    size — the transform the reference's ``getdataset`` actually uses
    (ref transform.py:312-351; its ``__call__`` ships with live
    breakpoints, the working body is center_crop_th_tw → resize)."""

    def __init__(self, size: Sequence[int], top_crop: bool = False,
                 interpolation_mode: str = "bilinear"):
        if len(size) != 2:
            raise ValueError("size should be tuple (height, width), "
                             f"instead got {size}")
        self.size = tuple(size)
        self.top_crop = top_crop
        self.interpolation_mode = interpolation_mode

    def __call__(self, clip):
        clip = center_crop_th_tw(clip, self.size[0], self.size[1],
                                 top_crop=self.top_crop)
        return resize(clip, self.size, self.interpolation_mode)

    def __repr__(self):
        return (f"{self.__class__.__name__}(size={self.size}, "
                f"interpolation_mode={self.interpolation_mode})")


class UCFCenterCropVideo:
    """Short-edge scale to size then center crop
    (ref transform.py:354-387)."""

    def __init__(self, size, interpolation_mode: str = "bilinear"):
        if isinstance(size, tuple):
            if len(size) != 2:
                raise ValueError("size should be tuple (height, width),"
                                 f" instead got {size}")
            self.size = size
        else:
            self.size = (size, size)
        self.interpolation_mode = interpolation_mode

    def __call__(self, clip):
        clip = resize_scale(clip, self.size, self.interpolation_mode)
        return center_crop(clip, self.size)

    def __repr__(self):
        return (f"{self.__class__.__name__}(size={self.size}, "
                f"interpolation_mode={self.interpolation_mode})")


class KineticsRandomCropResizeVideo:
    """random_shift_crop then resize (ref transform.py:390-412)."""

    def __init__(self, size, interpolation_mode: str = "bilinear",
                 rng: Optional[random.Random] = None):
        if isinstance(size, tuple):
            if len(size) != 2:
                raise ValueError("size should be tuple (height, width),"
                                 f" instead got {size}")
            self.size = size
        else:
            self.size = (size, size)
        self.interpolation_mode = interpolation_mode
        self.rng = rng

    def __call__(self, clip):
        clip = random_shift_crop(clip, rng=self.rng)
        return resize(clip, self.size, self.interpolation_mode)


class CenterCropVideo:
    """Plain center crop (ref transform.py:415-443)."""

    def __init__(self, size, interpolation_mode: str = "bilinear"):
        if isinstance(size, tuple):
            if len(size) != 2:
                raise ValueError("size should be tuple (height, width),"
                                 f" instead got {size}")
            self.size = size
        else:
            self.size = (size, size)
        self.interpolation_mode = interpolation_mode

    def __call__(self, clip):
        return center_crop(clip, self.size)

    def __repr__(self):
        return (f"{self.__class__.__name__}(size={self.size}, "
                f"interpolation_mode={self.interpolation_mode})")


class Normalize:
    """Mean/std normalization transform (ref transform.py:446-468)."""

    def __init__(self, mean, std, inplace: bool = False):
        self.mean = mean
        self.std = std
        self.inplace = inplace

    def __call__(self, clip):
        return normalize(clip, self.mean, self.std, self.inplace)

    def __repr__(self):
        return (f"{self.__class__.__name__}(mean={self.mean}, "
                f"std={self.std}, inplace={self.inplace})")


class Normalize255:
    """uint8 → float / 255 transform (ref transform.py:471-489)."""

    def __call__(self, clip):
        return normalize_video(clip)

    def __repr__(self):
        return self.__class__.__name__


class RandomHorizontalFlipVideo:
    """Random horizontal flip with probability p
    (ref transform.py:492-514)."""

    def __init__(self, p: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or random

    def __call__(self, clip):
        if self.rng.random() < self.p:
            clip = hflip(clip)
        return clip

    def __repr__(self):
        return f"{self.__class__.__name__}(p={self.p})"


class TemporalRandomCrop:
    """Random temporal window of ``size`` frames; returns
    (begin, end) indices (ref transform.py:520-534; also mirrored in
    data/t2v_dataset.py for the preprocessing path)."""

    def __init__(self, size: int, rng: Optional[random.Random] = None):
        self.size = size
        self.rng = rng or random

    def __call__(self, total_frames: int) -> Tuple[int, int]:
        rand_end = max(0, total_frames - self.size - 1)
        begin = self.rng.randint(0, rand_end)
        return begin, min(begin + self.size, total_frames)


class DynamicSampleDuration:
    """Random truncated duration ≥ half the clip, stride-aligned
    (ref transform.py:537-555)."""

    def __init__(self, t_stride: int, extra_1: bool,
                 rng: Optional[random.Random] = None):
        self.t_stride = t_stride
        self.extra_1 = extra_1
        self.rng = rng or random

    def __call__(self, t: int, h: int, w: int) -> Tuple[int, int]:
        if self.extra_1:
            t = t - 1
        choices = list(range(t + 1))[t // 2:][::self.t_stride]
        truncate_t = self.rng.choice(choices)
        if self.extra_1:
            truncate_t += 1
        return 0, truncate_t
