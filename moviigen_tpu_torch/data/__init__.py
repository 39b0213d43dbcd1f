"""Raw-video data layer of the port: decoding, transforms and the
preprocessing dataset (copies of ``moviigen_tpu/data``)."""

from .video_reader import read_video_frames, probe_video
from .t2v_dataset import T2VDataset, filter_resolution, TemporalRandomCrop
from . import transforms

__all__ = [
    "read_video_frames",
    "probe_video",
    "T2VDataset",
    "filter_resolution",
    "TemporalRandomCrop",
    "transforms",
]
