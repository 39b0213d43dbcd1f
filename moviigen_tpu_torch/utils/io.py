"""Video/image writing utilities.

The port's own copy of ``moviigen_tpu/utils/io.py`` (ref
``wan/utils/utils.py``): ``cache_video`` with retry, ``cache_image``,
``str2bool``. Takes numpy arrays (or anything ``np.asarray`` accepts).
Falls back mp4 → gif → npz where no video encoder (imageio, OpenCV) is
installed.
"""

from __future__ import annotations

import binascii
import logging
import os
import os.path as osp
import tempfile
from typing import Optional

import numpy as np


def rand_name(length: int = 8, suffix: str = "") -> str:
    """ref utils.py:14-20."""
    name = binascii.b2a_hex(os.urandom(length)).decode("utf-8")
    if suffix and not suffix.startswith("."):
        suffix = "." + suffix
    return name + suffix


def _to_uint8_frames(video: np.ndarray, value_range=(-1, 1)) -> np.ndarray:
    """[C, F, H, W] float in value_range → [F, H, W, C] uint8."""
    lo, hi = value_range
    v = np.clip(np.asarray(video, np.float32), lo, hi)
    v = (v - lo) / (hi - lo)
    v = (v * 255.0 + 0.5).astype(np.uint8)
    return v.transpose(1, 2, 3, 0)


def cache_video(tensor, save_file: Optional[str] = None, fps: int = 30,
                suffix: str = ".mp4", normalize: bool = True,
                value_range=(-1, 1), retry: int = 5) -> Optional[str]:
    """Write a [C, F, H, W] video tensor (ref utils.py:23-61).

    ``normalize``/``value_range`` follow the reference semantics (map
    value_range → [0,255]).
    """
    cache_file = osp.join(tempfile.gettempdir(), rand_name(suffix=suffix)) \
        if save_file is None else save_file

    frames = _to_uint8_frames(
        tensor, value_range if normalize else (0, 1))

    error = None
    for _ in range(retry):
        try:
            import imageio

            writer = imageio.get_writer(cache_file, fps=fps)
            for frame in frames:
                writer.append_data(frame)
            writer.close()
            return cache_file
        except Exception as e:  # no ffmpeg backend, bad container, ...
            error = str(e)  # not e: a cycle through its traceback
    # OpenCV ships its own ffmpeg: try mp4v before giving up on .mp4
    if suffix == ".mp4" or cache_file.endswith(".mp4"):
        try:
            import cv2

            h, w = frames.shape[1:3]
            writer = cv2.VideoWriter(
                cache_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            if writer.isOpened():
                for frame in frames:
                    writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
                writer.release()
                return cache_file
            writer.release()
        except Exception as e:
            error = str(e)
    # fallbacks for environments without an mp4 encoder
    for alt_suffix, saver in ((".gif", "gif"), (".npz", "npz")):
        alt = osp.splitext(cache_file)[0] + alt_suffix
        try:
            if saver == "gif":
                import imageio

                imageio.mimsave(alt, frames, duration=1000.0 / fps)
            else:
                np.savez_compressed(alt, video=frames, fps=fps)
            logging.warning("cache_video: mp4 failed (%s); wrote %s",
                            error, alt)
            return alt
        except Exception as e:
            error = str(e)
    logging.error("cache_video failed: %s", error)
    return None


def cache_image(tensor, save_file: str, nrow: int = 8,
                normalize: bool = True, value_range=(-1, 1),
                retry: int = 5) -> Optional[str]:
    """Write an image grid (ref utils.py:64-91). tensor: [C, H, W] or
    [B, C, H, W]."""
    arr = np.asarray(tensor, np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    b, c, h, w = arr.shape
    ncol = min(nrow, b)
    rows = (b + ncol - 1) // ncol
    grid = np.zeros((c, rows * h, ncol * w), arr.dtype)
    for i in range(b):
        r, col = divmod(i, ncol)
        grid[:, r * h:(r + 1) * h, col * w:(col + 1) * w] = arr[i]
    frame = _to_uint8_frames(grid[:, None],
                             value_range if normalize else (0, 1))[0]
    error = None
    for _ in range(retry):
        try:
            import imageio

            imageio.imwrite(save_file, frame)
            return save_file
        except Exception as e:
            error = str(e)
    logging.error("cache_image failed: %s", error)
    return None


def str2bool(v) -> bool:
    """ref utils.py:94-118."""
    import argparse

    if isinstance(v, bool):
        return v
    v = str(v).lower()
    if v in ("yes", "true", "t", "y", "1"):
        return True
    if v in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected (True/False)")
