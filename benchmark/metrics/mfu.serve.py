"""The whole DiT step's share of the card's dense bf16 peak (the DiT
layer), in %: see ``_share.mfu``."""

from benchmark.metrics import _share


def read(ctx):
    return _share.mfu(ctx, "serve")
