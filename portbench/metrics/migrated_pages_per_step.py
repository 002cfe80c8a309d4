"""Pages placement moved a step: the window's change in the program's
``pgdemote_total + pgpromote_total`` over its steps."""


def read(ctx):
    if not ctx.window_steps:
        return None
    return ctx.migrated / ctx.window_steps
