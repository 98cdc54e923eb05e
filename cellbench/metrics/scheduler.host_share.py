"""Share of ``BatchScheduler.run()``'s wall spent outside the engine's
``prefill_slot`` and ``decode_segment`` calls: the scheduler, the KV
pool, admission, the fetch of each segment's tokens and the closed
loop's own tick.  Read from the benchmark's spans around the two calls,
each ending in a synchronize, over the run's wall outside the profiled
window (inside it the calls do not synchronize)."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["spans"].get("run"):
        return None
    prof = ctx.get("profile")
    wall = ctx["spans"]["run"] - (prof["host_window_s"] if prof else 0.0)
    inside = sum(c["wall_s"] for c in ctx["prefills"] + ctx["decodes"]
                 if c["synced"])
    if wall <= 0:
        return None
    return 100.0 * (wall - inside) / wall
