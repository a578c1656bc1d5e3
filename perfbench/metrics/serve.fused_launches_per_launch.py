"""Launches of the fused SM kernel per launch served (the packing's
efficiency): the program's count (``kernels/_build.LAUNCHES``) over the
launches completed in the unprofiled part of the traced window."""


def read(ctx):
    n = ctx["window"]["launches"].get("fused_sm_run", 0)
    done = ctx["window"].get("completed", 0)
    return n / done if n and done else None
