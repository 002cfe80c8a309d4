"""``flash_attention``'s share of its roofline in the traced prefills: the
least time of its launches (the larger of FLOPs at 67 TFLOP/s and q, k,
v and the output at 3.35 TB/s, a launch) over their device time, in %."""


def read(ctx):
    secs, launches = ctx.trace.device(within=("admit",), name="flash_attention_kernel")
    if not launches or not ctx.admits:
        return None
    bound = sum(ctx.work.prefill_work(ctx.shapes, a["prompt_len"])["flash_bound_s"]
                for a in ctx.admits)
    return 100.0 * bound / secs
