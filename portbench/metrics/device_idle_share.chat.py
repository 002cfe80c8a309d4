"""Share of the traced slice of a chat cell in which no device
operation ran, in %."""


def read(ctx):
    if not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
