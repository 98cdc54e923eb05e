"""The window's useful forward FLOPs (every prefill admitted in it and
every generated token that reached the host in it, counted from the
configuration's widths by ``cellbench/flops.py``: the routed experts
only, the causal attention's pairs, one row of logits a forward) over
the H100's bf16 peak times the window's seconds."""

from cellbench.flops import PEAK_BF16_FLOPS


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["serve_flops"]:
        return None
    return 100.0 * ctx["serve_flops"] / (PEAK_BF16_FLOPS * ctx["window_s"])
