"""Device milliseconds a decode step in the MoE layers (``models/moe.py``:
``moe_route``, ``moe_dispatch``, the expert products and activation,
``moe_combine``): operations launched inside the wrapped MoE call within
``step`` spans, over the traced steps."""


def read(ctx):
    n = ctx.trace.n_spans("step")
    secs, launches = ctx.trace.device(within=("step", "moe"))
    if not n or not launches:
        return None
    return 1e3 * secs / n
