"""Device kernel launches a decode step: kernel events of the trace whose
launch lies in a ``step`` span, over the traced steps (the engine front
end, ``serving/engine.py``)."""


def read(ctx):
    n = ctx.trace.n_spans("step")
    launches = ctx.trace.device(within=("step",), kernels_only=True)[1]
    if not n or not launches:
        return None
    return launches / n
