"""The attention kernels' share of their roofline (the attention-kernel
layer), in %: see ``_share.attn_roofline``."""

from benchmark.metrics import _share


def read(ctx):
    return _share.attn_roofline(ctx, "serve")
