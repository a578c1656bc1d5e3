"""A Zamba2 training step's share of the chip's bf16 peak, in %: the
model FLOPs of a step (``hybrid_counts.train_flops`` from the cell's
configuration, batch and sequence: 6 a weight and token for every
product, each shared-block call counting its block, adapter and linear;
causal attention at the call's head width forward and backward; the
SSD's chunked einsums; nothing recomputed) times the steps of the
unprofiled part of the traced window, over that part's host-clock
seconds."""
from perfbench import counts, hybrid_counts


def read(ctx):
    shape = hybrid_counts.cell_shape(ctx)
    w = ctx["window"]
    if shape is None or not w["turns"] or not w["window_s"]:
        return None
    flops = hybrid_counts.train_flops(*shape)
    return 100 * w["turns"] * flops / w["window_s"] / counts.PEAK_FLOPS["bf16"]
