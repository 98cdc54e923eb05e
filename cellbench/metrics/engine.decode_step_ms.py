"""Wall of the ``decode_segment`` calls that end in a synchronize (every
call of the traced run outside the profiled window), over the decode
steps they ran."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    calls = [d for d in ctx["decodes"] if d["synced"]]
    steps = sum(d["steps"] for d in calls)
    if not steps:
        return None
    return 1e3 * sum(d["wall_s"] for d in calls) / steps
