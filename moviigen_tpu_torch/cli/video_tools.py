"""Dataset video/metadata tooling (host-side, no accelerator).

The port's own copy of ``moviigen_tpu/cli/video_tools.py``. Parity
targets — the reference's loose preprocessing utilities, consolidated
into one CLI with subcommands:

- ``resize``   ≡ ``scripts/data_preprocess/resize_videos.py`` (L24-112):
  batch-resize a directory tree of 16:9 videos to a target WxH/fps with a
  process pool; non-16:9 inputs are skipped (tolerance 10%, L18-21).
- ``metadata`` ≡ ``scripts/data_preprocess/video_process.py`` (L33-97):
  walk a tree of videos + per-folder caption CSVs ("Filename",
  "Video Description") and emit the dataset JSON consumed by
  ``T2V_dataset`` ({path, resolution, fps, duration, cap}).
- ``copy-csv`` ≡ ``scripts/data_preprocess/others/copy_csv.py`` (L6-33):
  mirror all CSVs under src into dst preserving structure.

Differences from the reference: decoding/encoding goes through this
repo's decoder chain (decord → torchcodec → cv2 → imageio;
``data/video_reader.py``) instead of moviepy/skimage, and failures are
reported per-file instead of aborting the pool.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import shutil
import sys
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path
from typing import Optional

import numpy as np

VIDEO_EXTENSIONS = {".mp4", ".avi", ".mov", ".mkv", ".webm"}


def is_16_9_ratio(width: int, height: int, tolerance: float = 0.1) -> bool:
    """resize_videos.py:18-21."""
    target = 16 / 9
    return abs(width / height - target) <= target * tolerance


def _resample_indices(n_frames: int, src_fps: float, dst_fps: float):
    """Frame indices after fps retiming (nearest-frame, duration kept) —
    the effect of moviepy's ``set_fps`` (resize_videos.py:51)."""
    if src_fps <= 0 or dst_fps <= 0 or n_frames == 0:
        return list(range(n_frames))
    duration = n_frames / src_fps
    out_n = max(int(round(duration * dst_fps)), 1)
    idx = np.minimum(np.round(np.arange(out_n) * src_fps / dst_fps),
                     n_frames - 1).astype(int)
    return idx.tolist()


def resize_one(input_file: str, output_file: str, width: int, height: int,
               fps: float):
    """Resize a single video (resize_videos.py:24-62). Returns
    (name, status, message)."""
    from ..data.video_reader import probe_video, read_video_frames
    from ..utils.io import cache_video

    name = os.path.basename(input_file)
    try:
        n, src_fps, h, w = probe_video(input_file)
        if not is_16_9_ratio(w, h):
            return (name, "skipped", "Not 16:9")
        idx = _resample_indices(n, src_fps, fps)
        frames = read_video_frames(input_file, idx)  # [T, H, W, 3] uint8

        try:
            import cv2

            resized = np.stack([
                cv2.resize(f, (width, height), interpolation=cv2.INTER_AREA)
                for f in frames])
        except ImportError:  # nearest via numpy index maps
            ys = np.minimum((np.arange(height) * frames.shape[1])
                            // height, frames.shape[1] - 1)
            xs = np.minimum((np.arange(width) * frames.shape[2])
                            // width, frames.shape[2] - 1)
            resized = frames[:, ys][:, :, xs]

        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        if os.path.exists(output_file):
            os.unlink(output_file)
        out = cache_video(resized.transpose(3, 0, 1, 2).astype(np.float32),
                          save_file=output_file, fps=int(fps),
                          value_range=(0, 255))
        if out is None:
            return (name, "failed", "no encoder")
        return (name, "success", None)
    except Exception as e:  # pool worker: report, don't raise
        return (name, "failed", str(e))


def cmd_resize(args) -> int:
    """resize_videos.py:65-112."""
    input_path = Path(args.input_dir)
    output_path = Path(args.output_dir)
    output_path.mkdir(parents=True, exist_ok=True)

    files = [f for f in input_path.rglob("*")
             if f.is_file() and f.suffix.lower() in VIDEO_EXTENSIONS]
    if not files:
        print(f"No video files found in {args.input_dir}")
        return 1
    print(f"Found {len(files)} videos; "
          f"target {args.width}x{args.height} @ {args.fps}fps")

    jobs = [(str(f), str(output_path / f.relative_to(input_path)),
             args.width, args.height, args.fps) for f in files]
    successful, skipped, failed = 0, 0, []
    if args.max_workers <= 1:
        results = (resize_one(*j) for j in jobs)
    else:
        pool = ProcessPoolExecutor(max_workers=args.max_workers)
        futures = [pool.submit(resize_one, *j) for j in jobs]
        results = (f.result() for f in as_completed(futures))
    for fname, status, message in results:
        if status == "success":
            successful += 1
        elif status == "skipped":
            skipped += 1
        else:
            failed.append((fname, message))
    if args.max_workers > 1:
        pool.shutdown()

    print(f"\nDone! Processed: {successful}, Skipped: {skipped}, "
          f"Failed: {len(failed)}")
    for fname, error in failed:
        print(f"- {fname}: {error}")
    return 0


def process_csv(csv_path: str):
    """Filename → description map (video_process.py:33-49)."""
    out = {}
    with open(csv_path, "r", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        required = {"Filename", "Video Description"}
        if not required.issubset(reader.fieldnames or ()):
            raise ValueError(
                f"CSV missing required columns: "
                f"{required - set(reader.fieldnames or ())}")
        for row in reader:
            name = row["Filename"].strip()
            if name in out:
                logging.warning("duplicate filename %s in %s",
                                name, csv_path)
            out[name] = row["Video Description"].strip()
    return out


def cmd_metadata(args) -> int:
    """video_process.py:51-97: tree of videos + caption CSVs → dataset
    JSON (the entry format ``T2V_dataset``/``read_jsons`` consumes)."""
    from ..data.video_reader import probe_video

    src = args.src_dir
    result = []
    for root, _, files in os.walk(src):
        csvs = sorted(f for f in files if f.endswith(".csv"))
        if not csvs:
            continue
        if len(csvs) > 1:
            logging.warning("multiple CSVs in %s, using %s", root, csvs[0])
        try:
            caption_map = process_csv(os.path.join(root, csvs[0]))
        except Exception as e:
            logging.error("CSV failed %s: %s", csvs[0], e)
            continue
        for fname in sorted(files):
            if Path(fname).suffix.lower() not in VIDEO_EXTENSIONS:
                continue
            path = os.path.join(root, fname)
            try:
                n, fps, h, w = probe_video(path)
            except Exception as e:
                logging.error("video failed %s: %s", path, e)
                continue
            desc = caption_map.get(fname, "")
            result.append({
                "path": os.path.relpath(path, src).replace("\\", "/"),
                "resolution": {"width": w, "height": h},
                "fps": fps,
                "duration": n / fps if fps > 0 else 0,
                "cap": [desc] if desc else [],
            })
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=2, ensure_ascii=False)
    print(f"Wrote {len(result)} entries to {args.output}")
    return 0


def cmd_copy_csv(args) -> int:
    """copy_csv.py:6-33."""
    src, dst = Path(args.src_dir), Path(args.dst_dir)
    files = list(src.rglob("*.csv"))
    if not files:
        print(f"No CSV files found in {args.src_dir}")
        return 1
    print(f"Found {len(files)} CSV files")
    for f in files:
        target = dst / f.relative_to(src)
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, target)
        print(f"Copied: {f} -> {target}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="moviigen_tpu_torch.cli.video_tools",
        description="dataset video/metadata tooling")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("resize",
                       help="batch-resize 16:9 videos (resize_videos.py)")
    r.add_argument("--input_dir", required=True)
    r.add_argument("--output_dir", required=True)
    r.add_argument("--width", type=int, default=832)
    r.add_argument("--height", type=int, default=480)
    r.add_argument("--fps", type=float, default=30)
    r.add_argument("--max_workers", type=int, default=4)
    r.set_defaults(fn=cmd_resize)

    m = sub.add_parser("metadata",
                       help="videos + caption CSVs → dataset JSON "
                            "(video_process.py)")
    m.add_argument("src_dir")
    m.add_argument("output", nargs="?", default="output.json")
    m.set_defaults(fn=cmd_metadata)

    c = sub.add_parser("copy-csv",
                       help="mirror CSVs preserving structure (copy_csv.py)")
    c.add_argument("--src_dir", required=True)
    c.add_argument("--dst_dir", required=True)
    c.set_defaults(fn=cmd_copy_csv)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
