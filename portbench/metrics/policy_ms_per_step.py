"""Host milliseconds a decode step in placement: the wrapped
``policy.step`` and ``kv.pool.end_interval`` spans (``core/tpp.py``,
``core/page_pool.py``) over the traced steps."""


def read(ctx):
    n = ctx.trace.n_spans("step")
    if not n or not ctx.trace.n_spans("policy"):
        return None
    return 1e3 * (ctx.trace.span_s("policy") + ctx.trace.span_s("end_interval")) / n
