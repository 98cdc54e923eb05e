"""Device kernels the profiler saw run per training step in its window
(copies and fills left out)."""


def read(ctx):
    prof = ctx.get("profile")
    if ctx["kind"] != "train" or not prof or not prof["launches"]:
        return None
    return prof["launches"] / ctx["profile_steps"]
