"""Vision-input preprocessing for Qwen-VL prompt extension.

The port's own copy of ``moviigen_tpu/utils/qwen_vl.py`` (host-side PIL
and numpy; videos decode through the port's ``data/video_reader.py``).
Parity target: ``wan/utils/qwen_vl_utils.py`` (itself vendored from
qwen-vl-utils) — smart resizing to ViT pixel budgets
(``smart_resize``, qwen_vl_utils.py:54-83), image fetching from
path/URL/base64/PIL (``fetch_image`` L85-131), fps-aware video frame
sampling (``smart_nframes`` L134-180, ``fetch_video`` L274-313), and
conversation scanning (``process_vision_info`` L344-363).

Host-side and framework-neutral by design: images are PIL, videos are
``numpy`` float32 ``[T, C, H, W]`` arrays (the reference returns torch
TCHW tensors — a Qwen-VL ``AutoProcessor`` accepts either). Decoding
rides this repo's decoder fallback chain (``data/video_reader.py``)
instead of hard-requiring torchvision/decord.
"""

from __future__ import annotations

import base64
import logging
import math
from io import BytesIO
from typing import List, Optional, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

# ref qwen_vl_utils.py:25-36
IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(number, factor: int) -> int:
    """Closest integer to ``number`` divisible by ``factor``
    (ref L39-41)."""
    return round(number / factor) * factor


def ceil_by_factor(number, factor: int) -> int:
    """Smallest multiple of ``factor`` ≥ ``number`` (ref L44-46)."""
    return math.ceil(number / factor) * factor


def floor_by_factor(number, factor: int) -> int:
    """Largest multiple of ``factor`` ≤ ``number`` (ref L49-51)."""
    return math.floor(number / factor) * factor


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS,
                 max_pixels: int = MAX_PIXELS) -> Tuple[int, int]:
    """Resize target with both dims divisible by ``factor``, total pixels
    inside [min_pixels, max_pixels], aspect ratio approximately kept
    (ref L54-83, same arithmetic)."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"absolute aspect ratio must be smaller than {MAX_RATIO}, "
            f"got {max(height, width) / min(height, width)}")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def fetch_image(ele: dict, size_factor: int = IMAGE_FACTOR):
    """dict with ``image``/``image_url`` (path, file://, data: URI,
    http(s) URL, or PIL.Image) → smart-resized RGB PIL image
    (ref L85-131)."""
    from PIL import Image

    image = ele["image"] if "image" in ele else ele["image_url"]
    image_obj = None
    if isinstance(image, Image.Image):
        image_obj = image
    elif isinstance(image, np.ndarray):
        image_obj = Image.fromarray(image.astype(np.uint8))
    elif image.startswith("http://") or image.startswith("https://"):
        try:
            import requests

            image_obj = Image.open(requests.get(image, stream=True).raw)
        except ImportError as e:
            raise ValueError(
                f"http(s) image input needs `requests`: {image}") from e
    elif image.startswith("file://"):
        image_obj = Image.open(image[7:])
    elif image.startswith("data:image"):
        if "base64," in image:
            _, base64_data = image.split("base64,", 1)
            image_obj = Image.open(BytesIO(base64.b64decode(base64_data)))
    else:
        image_obj = Image.open(image)
    if image_obj is None:
        raise ValueError(
            "Unrecognized image input, support local path, http url, "
            f"base64 and PIL.Image, got {image}")
    image_obj = image_obj.convert("RGB")

    if "resized_height" in ele and "resized_width" in ele:
        resized_height, resized_width = smart_resize(
            ele["resized_height"], ele["resized_width"], factor=size_factor)
    else:
        width, height = image_obj.size
        resized_height, resized_width = smart_resize(
            height, width, factor=size_factor,
            min_pixels=ele.get("min_pixels", MIN_PIXELS),
            max_pixels=ele.get("max_pixels", MAX_PIXELS))
    return image_obj.resize((resized_width, resized_height))


def smart_nframes(ele: dict, total_frames: int,
                  video_fps: float) -> int:
    """Number of model-input frames from either ``nframes`` or ``fps``
    (+ ``min_frames``/``max_frames``) config — ref L134-180, same
    arithmetic and bounds check."""
    assert not ("fps" in ele and "nframes" in ele), \
        "Only accept either `fps` or `nframes`"
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(
            ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR)
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR)
        nframes = total_frames / video_fps * fps
        nframes = min(max(nframes, min_frames), max_frames)
        nframes = round_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes should in interval [{FRAME_FACTOR}, "
            f"{total_frames}], but got {nframes}.")
    return int(nframes)


def _read_video(ele: dict) -> Tuple[np.ndarray, float]:
    """Decode via the repo decoder chain → ([T, H, W, 3] uint8, fps).

    Replaces the reference's torchvision/decord backend pair
    (ref L183-265); ``video_start``/``video_end`` (seconds) trim the
    frame range like the torchvision branch."""
    from ..data.video_reader import probe_video, read_video_frames

    path = ele["video"]
    if path.startswith("file://"):
        path = path[7:]
    total, fps, _, _ = probe_video(path)
    start = int(round(ele.get("video_start", 0.0) * fps))
    end = total - 1 if "video_end" not in ele \
        else min(total - 1, int(round(ele["video_end"] * fps)))
    start = max(0, min(start, total - 1))
    span = end - start + 1
    nframes = smart_nframes(ele, total_frames=span, video_fps=fps)
    idx = np.round(np.linspace(start, end, nframes)).astype(np.int64)
    return read_video_frames(path, frame_indices=idx.tolist()), fps


def _resize_frames(frames: np.ndarray, height: int,
                   width: int) -> np.ndarray:
    """Bicubic per-frame resize, [T, H, W, 3] uint8 → [T, C, H', W']
    float32 (≡ torchvision ``resize(..., BICUBIC, antialias=True)`` +
    ``.float()``, ref L305-311)."""
    from PIL import Image

    out = np.empty((frames.shape[0], 3, height, width), np.float32)
    for i, f in enumerate(frames):
        im = Image.fromarray(f).resize((width, height), Image.BICUBIC)
        out[i] = np.asarray(im, np.float32).transpose(2, 0, 1)
    return out


def fetch_video(ele: dict, image_factor: int = IMAGE_FACTOR
                ) -> Union[np.ndarray, List]:
    """dict with ``video`` (path → float32 [T, C, H, W]; list of image
    specs → list of PIL images, padded to a FRAME_FACTOR multiple) —
    ref L274-330."""
    if isinstance(ele["video"], str):
        video, _ = _read_video(ele)
        nframes, height, width = video.shape[0], video.shape[1], \
            video.shape[2]
        min_pixels = ele.get("min_pixels", VIDEO_MIN_PIXELS)
        total_pixels = ele.get("total_pixels", VIDEO_TOTAL_PIXELS)
        max_pixels = max(
            min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR),
            int(min_pixels * 1.05))
        max_pixels = ele.get("max_pixels", max_pixels)
        if "resized_height" in ele and "resized_width" in ele:
            resized_height, resized_width = smart_resize(
                ele["resized_height"], ele["resized_width"],
                factor=image_factor)
        else:
            resized_height, resized_width = smart_resize(
                height, width, factor=image_factor,
                min_pixels=min_pixels, max_pixels=max_pixels)
        return _resize_frames(video, resized_height, resized_width)

    assert isinstance(ele["video"], (list, tuple))
    process_info = dict(ele)
    process_info.pop("type", None)
    process_info.pop("video", None)
    images = [
        fetch_image({"image": el, **process_info},
                    size_factor=image_factor)
        for el in ele["video"]
    ]
    nframes = ceil_by_factor(len(images), FRAME_FACTOR)
    if len(images) < nframes:
        images.extend([images[-1]] * (nframes - len(images)))
    return images


def extract_vision_info(conversations) -> List[dict]:
    """Collect image/video content elements from chat messages
    (ref L333-346)."""
    vision_infos = []
    if isinstance(conversations[0], dict):
        conversations = [conversations]
    for conversation in conversations:
        for message in conversation:
            if isinstance(message["content"], list):
                for ele in message["content"]:
                    if ("image" in ele or "image_url" in ele
                            or "video" in ele or ele.get("type") in
                            ("image", "image_url", "video")):
                        vision_infos.append(ele)
    return vision_infos


def process_vision_info(conversations) -> Tuple[Optional[list],
                                                Optional[list]]:
    """(image_inputs, video_inputs) ready for a Qwen-VL processor
    (ref L349-363)."""
    image_inputs, video_inputs = [], []
    for vision_info in extract_vision_info(conversations):
        if "image" in vision_info or "image_url" in vision_info:
            image_inputs.append(fetch_image(vision_info))
        elif "video" in vision_info:
            video_inputs.append(fetch_video(vision_info))
        else:
            raise ValueError("image, image_url or video should in content.")
    return (image_inputs or None, video_inputs or None)
