"""The device's idle share of the traced window (the device layer), in
%: see ``_share.idle_pct``."""

from benchmark.metrics import _share


def read(ctx):
    return _share.idle_pct(ctx, "train")
