"""Decode tokens a second in a cell whose throughput the host paces:
every output token returned in the traced run's window after its slice
was traced and read, over those seconds (the end-to-end
``decode_tokens_per_s`` counted so).  The host runs slower after the
profiler has run, so this reads below an untraced run: compare it with
traced runs only."""


def read(ctx):
    return ctx.tokens_per_s or None
