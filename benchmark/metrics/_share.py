"""What the share readers have in common: the card's peaks from the table
``benchmark/peaks.json`` (a card the table does not hold has no share,
and its readers read nothing), and the traced window's device seconds by
kernel category."""

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())["cards"]


def peak(ctx):
    return PEAKS.get(ctx.get("card_kind") or "")


def mfu(ctx, kind):
    """The DiT's flops of the window's steps (``counters.dit_flops``; a
    training step counts three forwards) over the window's seconds at the
    card's dense bf16 peak, in %."""
    p = peak(ctx)
    if ctx["kind"] != kind or p is None or not ctx["steps"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * p["bf16_flops_s"])


def attn_roofline(ctx, kind):
    """The least time the window's attention could take, max(ops / bf16
    peak, bytes / HBM peak) from ``counters.attention_work``, over the
    device seconds of the kernels that do attention, in %."""
    p = peak(ctx)
    if ctx["kind"] != kind or p is None:
        return None
    busy = ctx["trace"].category_s.get("attention", 0.0)
    if busy <= 0:
        return None
    least = max(ctx["attn_ops"] / p["bf16_flops_s"],
                ctx["attn_bytes"] / p["hbm_bytes_s"])
    return 100.0 * least / busy


def category_ms(ctx, kind, category):
    """Device ms per step of one kernel category in the traced window."""
    trace = ctx.get("trace")
    if (ctx["kind"] != kind or trace is None or not trace.kernels
            or not ctx["steps"]):
        return None
    return 1e3 * trace.category_s.get(category, 0.0) / ctx["steps"]


def idle_pct(ctx, kind):
    """The share of the traced window with no device activity, in %."""
    trace = ctx.get("trace")
    if ctx["kind"] != kind or trace is None or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
