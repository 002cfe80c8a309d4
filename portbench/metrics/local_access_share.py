"""Share of the window's page accesses served from the fast tier, in %:
the change of the program's ``vmstat.access_fast`` over that of
``access_fast + access_slow`` (the paper's local memory access)."""


def read(ctx):
    total = ctx.access_fast + ctx.access_slow
    return 100.0 * ctx.access_fast / total if total else None
