"""Share of the profiled training steps' window in which no operation ran
on the device (the union of every kernel's, copy's and fill's interval
in the profiler's trace)."""


def read(ctx):
    prof = ctx.get("profile")
    if ctx["kind"] != "train" or not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
