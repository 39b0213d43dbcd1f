"""Raw-video preprocessing dataset.

The port's own copy of ``moviigen_tpu/data/t2v_dataset.py`` (ref
``scripts/dataset/t2v_datasets.py`` T2V_dataset): merge file of JSON
annotation lists, caption/fps/duration/resolution filters, fps resampling
to ``train_fps``, temporal random crop, cinematic aspect-ratio binning
with per-bin crop sizes, long-edge resize + random/center crop, [-1, 1]
normalization. Host-side numpy and OpenCV (the ``data`` extra). The
same seed draws the same crops as the JAX package: both seed the
global ``random``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .video_reader import read_video_frames

# ref t2v_datasets.py:311-316 — cinematic crop sizes per aspect bin
BIN_CROP_SIZES = (
    {"height": 832, "width": 1920},   # bin 0: ~9:21
    {"height": 1072, "width": 1920},  # bin 1: ~9:16
    {"height": 960, "width": 1280},   # bin 2: ~3:4
)


def filter_resolution(h: int, w: int, max_h_div_w_ratio: float,
                      min_h_div_w_ratio: float) -> bool:
    """ref t2v_datasets.py:75."""
    return min_h_div_w_ratio <= h / w <= max_h_div_w_ratio


class TemporalRandomCrop:
    """ref scripts/dataset/transform.py:520-535."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, total_frames: int) -> Tuple[int, int]:
        rand_end = max(0, total_frames - self.size - 1)
        begin = random.randint(0, rand_end)
        end = min(begin + self.size, total_frames)
        return begin, end


def _resize_frames(video: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """[T, H, W, C] uint8 → [T, nh, nw, C] uint8, OpenCV's INTER_LINEAR."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "resizing frames needs OpenCV: install the package's 'data' "
            "extra (opencv-python)") from e
    return np.stack([cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
                     for f in video])


def resize_and_crop(video: np.ndarray, target_size: int,
                    crop_size: Optional[Tuple[int, int]],
                    random_crop: bool = True) -> np.ndarray:
    """Long-edge resize maintaining aspect, then random/center crop
    (ref resize_maintain_aspect_ratio_enhanced, t2v_datasets.py:95-231).

    video: [T, H, W, C] uint8 → same layout, cropped.
    """
    t, h, w, c = video.shape
    ar = w / h

    adjusted = target_size
    if crop_size:
        if w >= h:
            need = int(crop_size[0] * w / h)
            adjusted = max(adjusted, need)
        else:
            need = int(crop_size[1] * h / w)
            adjusted = max(adjusted, need)

    if w >= h:
        nw, nh = adjusted, max(1, int(adjusted / ar))
    else:
        nh, nw = adjusted, max(1, int(adjusted * ar))

    if crop_size and (nh < crop_size[0] or nw < crop_size[1]):
        scale = max(crop_size[0] / nh, crop_size[1] / nw)
        nh = max(crop_size[0], int(nh * scale))
        nw = max(crop_size[1], int(nw * scale))

    resized = _resize_frames(video, nh, nw)

    if crop_size:
        ch, cw = crop_size
        if random_crop:
            top = random.randint(0, nh - ch)
            left = random.randint(0, nw - cw)
        else:
            top = (nh - ch) // 2
            left = (nw - cw) // 2
        resized = resized[:, top:top + ch, left:left + cw]
    return resized


def read_jsons(merge_file: str) -> List[Dict[str, Any]]:
    """Merge file: one JSON path per line (optionally 'folder,json');
    paths in annotations become absolute against the folder
    (ref t2v_datasets.py:759-799)."""
    items: List[Dict[str, Any]] = []
    with open(merge_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if "," in line:
                folder, json_path = line.split(",", 1)
            else:
                folder, json_path = os.path.dirname(line), line
            with open(json_path) as jf:
                annos = json.load(jf)
            for a in annos:
                if folder and not os.path.isabs(a.get("path", "")):
                    a["path"] = os.path.join(folder, a["path"])
                items.append(a)
    return items


class T2VDataset:
    """Preprocessing-time dataset over raw videos."""

    def __init__(self, data_merge_path: str, num_frames: int = 81,
                 train_fps: int = 16, max_height: int = 1080,
                 max_width: int = 1920, speed_factor: float = 1.0,
                 drop_short_ratio: float = 1.0,
                 video_length_tolerance_range: float = 2.0,
                 aspect_ratio_buckets: int = 4,
                 drop_bins: Sequence[int] = (),
                 random_crop: bool = True,
                 bin_crop_sizes: Optional[Sequence[Dict[str, int]]] = None,
                 seed: int = 42):
        self.num_frames = num_frames
        self.train_fps = train_fps
        self.max_height = max_height
        self.max_width = max_width
        self.speed_factor = speed_factor
        self.drop_short_ratio = drop_short_ratio
        self.video_length_tolerance_range = video_length_tolerance_range
        self.aspect_ratio_buckets = aspect_ratio_buckets
        self.drop_bins = set(drop_bins)
        self.random_crop = random_crop
        self.bin_crop_sizes = tuple(bin_crop_sizes) \
            if bin_crop_sizes is not None else BIN_CROP_SIZES
        self.temporal_sample = TemporalRandomCrop(num_frames)
        self.error_counts: Dict[str, int] = defaultdict(int)
        random.seed(seed)

        cap_list = read_jsons(data_merge_path)
        cap_list, self.sample_num_frames = self.define_frame_index(cap_list)
        self.aspect_ratios, self.cap_list = \
            self.calculate_aspect_ratios(cap_list)
        self.lengths = [i["sample_num_frames"] for i in self.cap_list]

    # ------------------------------------------------------------------

    def define_frame_index(self, cap_list):
        """Filter + fps-resample (ref t2v_datasets.py:637-755)."""
        new_list, sample_num_frames = [], []
        c = defaultdict(int)
        for i in cap_list:
            path = i.get("path", "")
            if i.get("cap") is None:
                c["cnt_no_cap"] += 1
                continue
            fps, duration = i.get("fps"), i.get("duration")
            if fps is None or duration is None:
                c["cnt_no_fps_duration"] += 1
                continue
            res = i.get("resolution") or {}
            height, width = res.get("height"), res.get("width")
            if not height or not width:
                c["cnt_no_resolution"] += 1
                continue
            aspect = self.max_height / self.max_width
            thr = 1.5
            if not filter_resolution(height, width, thr * aspect,
                                     aspect / thr):
                c["cnt_resolution_mismatch"] += 1
                continue
            i["num_frames"] = math.ceil(fps * duration)
            max_length = self.video_length_tolerance_range * (
                self.num_frames / self.train_fps * self.speed_factor)
            if i["num_frames"] / fps > max_length:
                c["cnt_too_long"] += 1
                continue
            interval = fps / self.train_fps
            frame_indices = np.arange(
                0, i["num_frames"], interval).astype(int)
            if len(frame_indices) < self.num_frames \
                    and random.random() < self.drop_short_ratio:
                c["cnt_too_short"] += 1
                continue
            if len(frame_indices) > self.num_frames:
                b, e = self.temporal_sample(len(frame_indices))
                frame_indices = frame_indices[b:e]
            i["sample_frame_index"] = frame_indices.tolist()
            i["sample_num_frames"] = len(frame_indices)
            sample_num_frames.append(i["sample_num_frames"])
            new_list.append(i)
            c["cnt_movie"] += 1
        logging.info("frame-index filter: %s → kept %d/%d",
                     dict(c), len(new_list), len(cap_list))
        return new_list, sample_num_frames

    def calculate_aspect_ratios(self, cap_list):
        """Bin by h/w into linspace(0.3, 0.9, buckets)
        (ref t2v_datasets.py:363-440)."""
        ratio_bins = np.linspace(0.3, 0.9, self.aspect_ratio_buckets)
        aspect_ratios, filtered = [], []
        for item in cap_list:
            res = item.get("resolution") or {}
            h, w = res.get("height", 0), res.get("width", 0)
            if h <= 0 or w <= 0:
                continue
            bucket = int(np.clip(np.digitize(h / w, ratio_bins) - 1, 0,
                                 self.aspect_ratio_buckets - 1))
            if bucket in self.drop_bins:
                continue
            item["aspect_ratio_bin"] = bucket
            filtered.append(item)
            aspect_ratios.append(bucket)
        return np.asarray(aspect_ratios, np.int64), filtered

    def __len__(self):
        return len(self.cap_list)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = self.cap_list[idx]
        path = item["path"]
        frame_indices = item["sample_frame_index"]
        video = read_video_frames(path, frame_indices)  # [T, H, W, C] u8

        bin_idx = item.get("aspect_ratio_bin", 1)
        if bin_idx < len(self.bin_crop_sizes):
            ch = self.bin_crop_sizes[bin_idx]["height"]
            cw = self.bin_crop_sizes[bin_idx]["width"]
        else:
            ch, cw = self.max_height, self.max_width

        video = resize_and_crop(video, self.max_width, (ch, cw),
                                random_crop=self.random_crop)
        # [T, H, W, C] u8 → [C, T, H, W] float in [-1, 1]
        # (ref t2v_datasets.py:554-558)
        vid = video.astype(np.float32).transpose(3, 0, 1, 2) / 127.5 - 1.0

        text = item["cap"]
        if isinstance(text, list):
            text = random.choice(text)
        return {
            "pixel_values": vid,
            "text": text,
            "path": path,
            "metadata": {
                "aspect_ratio_bin": bin_idx,
                "crop_dimensions": [ch, cw],
                "num_frames": len(frame_indices),
            },
        }
