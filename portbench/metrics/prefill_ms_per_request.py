"""Milliseconds a prefill: host clock around ``add_request``
(``ServingEngine._prefill_forward`` and the page writes), ending in a
synchronize, over the traced admissions."""


def read(ctx):
    if not ctx.admits:
        return None
    return 1e3 * sum(a["s"] for a in ctx.admits) / len(ctx.admits)
