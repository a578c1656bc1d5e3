"""Launches of the fused SM kernel a batch: the program's own count
(``kernels/_build.LAUNCHES``) over the unprofiled part of the traced
window, over the batches run there."""


def read(ctx):
    n = ctx["window"]["launches"].get("fused_sm_run", 0)
    turns = ctx["window"]["turns"]
    return n / turns if n and turns else None
