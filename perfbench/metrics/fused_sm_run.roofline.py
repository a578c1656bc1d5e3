"""The fused SM kernel's share of its roofline, in %: the bytes its
batches need, however the executor groups their blocks (each launch's
program in, its global memory once in and once out, each block's
counters out; ``counts.overlay_batch_bytes``) over HBM bandwidth,
divided by the kernel's device time in the profiled batches."""
from perfbench import counts, harness as H


def read(ctx):
    sec, calls = H.kernel_seconds(ctx, r"fused_sm_run_kernel")
    if not sec or not calls:
        return None
    need = ctx["facts"]["batch_bytes"] * ctx["profile"]["turns"]
    return 100 * counts.roofline_s(need, 0, "bf16") / sec
