"""Wall of the ``prefill_slot`` calls that end in a synchronize (every
call of the traced run outside the profiled window) per 1000 tokens they
prefilled."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    calls = [p for p in ctx["prefills"] if p["synced"]]
    toks = sum(p["new"] for p in calls)
    if not toks:
        return None
    return 1e3 * sum(p["wall_s"] for p in calls) / (toks / 1e3)
