"""The fused SM kernel's share of its roofline, in %: the bytes its
batches need (each dispatch group's programs, each launch's global
memory once in and once out, each block's counters out;
``counts.overlay_group_bytes``) over HBM bandwidth, divided by the
kernel's device time in the profiled batches."""
from perfbench import counts, harness as H


def read(ctx):
    sec, calls = H.kernel_seconds(ctx, r"fused_sm_run_kernel")
    if not sec or not calls:
        return None
    need = sum(ctx["facts"]["group_bytes"]) * ctx["profile"]["turns"]
    return 100 * counts.roofline_s(need, 0, "bf16") / sec
