"""``paged_attention``'s share of its roofline in the traced steps: the
least time of its launches (the valid K and V slots, q and the output at
3.35 TB/s, or its FLOPs at 67 TFLOP/s, whichever is larger, a launch)
over their device time, in %."""


def read(ctx):
    secs, launches = ctx.trace.device(within=("step",), name="paged_attention_kernel")
    if not launches:
        return None
    L = ctx.shapes.layers
    tk, rc = ctx.workload["topk_pages"], ctx.workload["recent_pages"]
    bound = 0.0
    for s in ctx.steps:
        wk = ctx.work.decode_step_work(ctx.shapes, s["positions"], tk, rc)
        bound += L * ctx.work.bound_s(wk["pa_bytes"] / L, wk["pa_flops"] / L)
    return 100.0 * bound / secs
