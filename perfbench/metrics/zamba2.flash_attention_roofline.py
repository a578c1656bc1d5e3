"""The flash forward's share of its roofline at a Zamba2 shared block's
call, in %: the least time the chip could take for the work of each
launch in the profiled steps (``counts.flash_fwd_work`` at the call's
shape from ``hybrid_counts.flash_shape``: q, k, v in, o and the
log-sum-exp out; QK^T and PV over the causal pairs), launches counted by
the program (``kernels/_build.LAUNCHES``), over the device time of the
forward's kernels (the cell's every flash call is at that shape)."""
from perfbench import counts, harness as H, hybrid_counts

#: the forward's kernels, every variant
KERNELS = r"(?<![A-Za-z0-9_])flash(_tc|_tc_wide)?_kernel"


def read(ctx):
    shape = hybrid_counts.cell_shape(ctx)
    if shape is None:
        return None
    fshape = hybrid_counts.flash_shape(*shape)
    sec, _ = H.kernel_seconds(ctx, KERNELS)
    calls = ctx["profile"]["launches"].get("flash_attention", 0)
    if not sec or not calls:
        return None
    return 100 * calls * counts.roofline_s(
        *counts.flash_fwd_work(*fshape), "bf16") / sec
