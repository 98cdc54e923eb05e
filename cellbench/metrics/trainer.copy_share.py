"""Share of the device's busy time in the profiled training steps spent
in copy and cast kernels (PyTorch's ``direct_copy`` and
``*_copy_kernel`` kernels: the bfloat16 casts of the float32 masters,
their gradients' casts back and the moments' reads), by kernel name."""

KEYS = ("copy_kernel",)


def read(ctx):
    prof = ctx.get("profile")
    if ctx["kind"] != "train" or not prof or prof["busy_s"] <= 0:
        return None
    t = sum(v[0] for k, v in prof["kernels"].items()
            if any(s in k for s in KEYS))
    return 100.0 * t / prof["busy_s"]
