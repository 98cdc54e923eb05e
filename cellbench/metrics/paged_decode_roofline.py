"""The paged decode kernel's share of its roofline: the least time the
H100 needs for every decode step in the profiled window (one call a
layer over every slot, each row at its context length that step; bytes
and FLOPs from ``cellbench/flops.py::paged_traffic``, bf16 pages) over
the device time of the kernel's launches there, by name."""

from cellbench.flops import bound_s, paged_traffic

NAME = "paged_decode_kernel"


def read(ctx):
    prof = ctx.get("profile")
    if ctx["kind"] != "serve" or not prof:
        return None
    t = sum(v[0] for k, v in prof["kernels"].items() if NAME in k)
    cfg, spec = ctx["cfg"], ctx["spec"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // h
    bound = 0.0
    for d in ctx["decodes"]:
        if not d["profiled"] or d["lengths"] is None:
            continue
        for step in range(d["steps"]):
            lens = [n + step for n in d["lengths"]]
            bound += bound_s(*paged_traffic(
                lens, kvh=kvh, g=h // kvh, dh=dh, ps=int(spec["page_size"]),
                q_itemsize=2, page_itemsize=2, scales=False))
    bound *= cfg["num_hidden_layers"]
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
