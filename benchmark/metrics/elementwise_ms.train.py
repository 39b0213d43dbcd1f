"""Device ms per step of the "elementwise / reduction / copy" kernels
(the torch-ops layer: norms, RoPE, modulation, casts, the optimizer's
updates), read from the traced window by ``kernel_categories.json``."""

from benchmark.metrics import _share


def read(ctx):
    return _share.category_ms(ctx, "train", "elementwise")
