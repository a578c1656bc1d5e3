"""The flash backward's share of its roofline at a Zamba2 shared block's
call, in %: the least time the chip could take for the work of each
launch in the profiled steps (``counts.flash_bwd_work`` at the call's
shape from ``hybrid_counts.flash_shape``: q, o, dO, k, v and the
log-sum-exp in, dQ, dK, dV out; five products over the causal pairs),
launches counted by the program (``kernels/_build.LAUNCHES``), over the
device time of all the backward's kernels (delta, dK/dV, dQ and the
partials' sum, every variant; the cell's every flash call is at that
shape)."""
from perfbench import counts, harness as H, hybrid_counts

KERNELS = r"(?<![A-Za-z0-9_])(delta|dkv|dq)(_tc|_tc_wide|_sum)?_kernel"


def read(ctx):
    shape = hybrid_counts.cell_shape(ctx)
    if shape is None:
        return None
    fshape = hybrid_counts.flash_shape(*shape)
    sec, _ = H.kernel_seconds(ctx, KERNELS)
    calls = ctx["profile"]["launches"].get("flash_attention_bwd", 0)
    if not sec or not calls:
        return None
    return 100 * calls * counts.roofline_s(
        *counts.flash_bwd_work(*fshape), "bf16") / sec
