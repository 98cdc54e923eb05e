"""The flash prefill kernel's share of its roofline: the least time the
H100 needs for every flash call in the profiled window (each admission's
whole-prompt prefill calls it once a layer on [1, H, S, Dh], causal;
FLOPs and bytes from ``cellbench/flops.py::flash_traffic``) over the
device time of the kernel's launches there, by name."""

from cellbench.flops import bound_s, flash_traffic

NAMES = ("flash_mma_kernel", "flash_fwd_kernel")


def read(ctx):
    prof = ctx.get("profile")
    if ctx["kind"] != "serve" or not prof:
        return None
    t = sum(v[0] for k, v in prof["kernels"].items()
            if any(n in k for n in NAMES))
    cfg = ctx["cfg"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // h
    bound = 0.0
    for p in ctx["prefills"]:
        if not p["profiled"] or p["past"]:
            continue
        s = p["new"]
        bound += bound_s(*flash_traffic(
            [s], h=h, kvh=kvh, sq=s, sk=s, dh=dh, itemsize=2, causal=True,
            q_offset=0)) * cfg["num_hidden_layers"]
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
