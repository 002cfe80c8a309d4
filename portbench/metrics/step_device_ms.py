"""Device milliseconds a decode step (``_batched_step_impl`` and the
selection and copies around it): device time of the operations launched
inside ``step`` spans over the traced steps."""


def read(ctx):
    n = ctx.trace.n_spans("step")
    secs, launches = ctx.trace.device(within=("step",))
    if not n or not launches:
        return None
    return 1e3 * secs / n
