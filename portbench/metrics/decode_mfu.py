"""The decode steps' share of the float32 peak: model FLOPs of the traced
steps (the k routed experts, the attended slots, the LM head; counted
from shapes) over their host-clock time and 67 TFLOP/s, in %.  Read only
where the trace saw the device work (a CUDA run)."""


def read(ctx):
    if not ctx.steps or not ctx.trace.device(within=("step",))[1]:
        return None
    tk, rc = ctx.workload["topk_pages"], ctx.workload["recent_pages"]
    flops = sum(ctx.work.decode_step_work(ctx.shapes, s["positions"], tk, rc)["flops"]
                for s in ctx.steps)
    secs = sum(s["s"] for s in ctx.steps)
    return 100.0 * flops / secs / ctx.work.PEAK_FLOPS["float32"]
