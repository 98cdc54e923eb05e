"""Share of the admitted prompt tokens the prefix cache served:
1 - prefilled_tokens / prompt_tokens of the scheduler's own counters."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    m = ctx["metrics"]
    if not m.get("prompt_tokens"):
        return None
    return 100.0 * (1.0 - m["prefilled_tokens"] / m["prompt_tokens"])
