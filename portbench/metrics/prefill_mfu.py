"""The prefills' share of the float32 peak: model FLOPs of the traced
prompts (no LM head) over their host-clock time, ending in a
synchronize, and 67 TFLOP/s, in %."""


def read(ctx):
    if not ctx.admits or not ctx.trace.device(within=("admit",))[1]:
        return None
    flops = sum(ctx.work.prefill_work(ctx.shapes, a["prompt_len"])["flops"] for a in ctx.admits)
    secs = sum(a["s"] for a in ctx.admits)
    return 100.0 * flops / secs / ctx.work.PEAK_FLOPS["float32"]
