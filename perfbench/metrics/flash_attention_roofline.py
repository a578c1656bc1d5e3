"""The flash forward's share of its roofline, in %: the least time the
chip could take for the work of each launch in the profiled steps
(``counts.flash_fwd_work`` from the cell's shapes: q, k, v in, o and the
log-sum-exp out; QK^T and PV over the causal pairs), launches counted by
the program (``kernels/_build.LAUNCHES``, the recompute's included), over
the device time of the forward's kernels."""
from perfbench import counts, harness as H

#: the forward's kernels, every variant
KERNELS = r"(?<![A-Za-z0-9_])flash(_tc|_tc_wide)?_kernel"


def read(ctx):
    sec, _ = H.kernel_seconds(ctx, KERNELS)
    calls = ctx["profile"]["launches"].get("flash_attention", 0)
    if not sec or not calls:
        return None
    return 100 * calls * counts.roofline_s(*ctx["facts"]["flash_fwd"],
                                           "bf16") / sec
