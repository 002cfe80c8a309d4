"""Device microseconds a step in the data plane's copies
(``page_copy_kernel``: ``page_gather`` and ``page_scatter``,
``serving/kv_cache.py``) over the traced steps."""


def read(ctx):
    n = ctx.trace.n_spans("step")
    secs, launches = ctx.trace.device(name="page_copy_kernel")
    if not n or not launches:
        return None
    return 1e6 * secs / n
