"""Share of the device's busy time in the profiled training steps spent
in matrix products on the tensor cores (cuBLAS's ``nvjet`` kernels and
the CUTLASS, ``gemm`` and ``xmma`` ones), by kernel name: the part of
the step that the model's FLOPs need."""

KEYS = ("nvjet", "cutlass", "gemm", "xmma")


def read(ctx):
    prof = ctx.get("profile")
    if ctx["kind"] != "train" or not prof or prof["busy_s"] <= 0:
        return None
    t = sum(v[0] for k, v in prof["kernels"].items()
            if any(s in k for s in KEYS))
    return 100.0 * t / prof["busy_s"]
