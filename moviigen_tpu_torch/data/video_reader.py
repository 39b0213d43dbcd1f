"""Host-side video decoding with a fallback chain.

The port's own copy of ``moviigen_tpu/data/video_reader.py`` (ref
``scripts/dataset/t2v_datasets.py:463-516``): decord → torchcodec →
OpenCV (bundled ffmpeg) → imageio, whichever is installed; ``.npy`` /
``.npz`` arrays load directly (synthetic data, and a machine with no
decoder).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np


def probe_video(path: str) -> Tuple[int, float, int, int]:
    """Return (num_frames, fps, height, width)."""
    if path.endswith((".npy", ".npz")):
        arr = _load_array(path)
        return arr.shape[0], 16.0, arr.shape[1], arr.shape[2]
    try:
        import decord

        vr = decord.VideoReader(path, num_threads=1)
        h, w = vr[0].shape[:2]
        return len(vr), float(vr.get_avg_fps()), h, w
    except ImportError:
        pass
    try:
        import cv2

        cap = cv2.VideoCapture(path)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 16.0
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        cap.release()
        return n, float(fps), h, w
    except ImportError:
        raise ImportError("no video decoder available (decord/cv2)")


def _load_array(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        z = np.load(path)
        return z[list(z.keys())[0]]
    return np.load(path)


def read_video_frames(path: str,
                      frame_indices: Optional[Sequence[int]] = None
                      ) -> np.ndarray:
    """Decode frames → [T, H, W, 3] uint8 (RGB).

    ``frame_indices`` selects specific frames (fps-resampled indices from
    the dataset); None decodes everything.
    """
    if path.endswith((".npy", ".npz")):
        arr = _load_array(path)
        if frame_indices is not None:
            arr = arr[np.asarray(frame_indices)]
        return arr.astype(np.uint8)

    errors = []
    try:
        import decord

        vr = decord.VideoReader(path, num_threads=1)
        idx = list(frame_indices) if frame_indices is not None \
            else list(range(len(vr)))
        return vr.get_batch(idx).asnumpy()
    except ImportError:
        pass
    except Exception as e:  # decord decode failure → fall through
        errors.append(f"decord: {e}")

    try:
        from torchcodec.decoders import VideoDecoder

        dec = VideoDecoder(path)
        idx = list(frame_indices) if frame_indices is not None \
            else list(range(dec.metadata.num_frames))
        frames = dec.get_frames_at(indices=idx).data  # [T, C, H, W]
        return np.asarray(frames).transpose(0, 2, 3, 1)
    except ImportError:
        pass
    except Exception as e:
        errors.append(f"torchcodec: {e}")

    try:
        import cv2

        cap = cv2.VideoCapture(path)
        want = set(int(i) for i in frame_indices) \
            if frame_indices is not None else None
        frames = {}
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if want is None or i in want:
                frames[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            i += 1
        cap.release()
        if want is not None:
            idx = [int(j) for j in frame_indices]
            last = max(frames) if frames else 0
            return np.stack([frames.get(j, frames[min(j, last)])
                             for j in idx])
        return np.stack([frames[j] for j in sorted(frames)])
    except ImportError:
        pass
    except Exception as e:
        errors.append(f"cv2: {e}")

    try:
        import imageio

        reader = imageio.get_reader(path)
        frames = [np.asarray(f) for f in reader]
        arr = np.stack(frames)
        if frame_indices is not None:
            arr = arr[np.asarray(frame_indices)]
        return arr
    except Exception as e:
        errors.append(f"imageio: {e}")

    raise RuntimeError(f"all decoders failed for {path}: {errors}")
