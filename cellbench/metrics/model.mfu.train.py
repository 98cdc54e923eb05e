"""6 N T + 12 L H Dh S T of every step completed in the window over the
H100's bf16 peak times the window's seconds (``cellbench/flops.py``): the
host clock over the same window as ``train_tokens_per_s``, which the
traced run keeps free of the profiler (it profiles after the window)."""

from cellbench.flops import PEAK_BF16_FLOPS, train_step_flops


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    sp = ctx["spec"]
    f = ctx["steps"] * train_step_flops(ctx["cfg"], int(sp["batch"]),
                                        int(sp["seq"]))
    return 100.0 * f / (PEAK_BF16_FLOPS * ctx["window_s"])
