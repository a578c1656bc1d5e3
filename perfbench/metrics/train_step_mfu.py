"""The whole training step's share of the chip's bf16 peak, in %: the
model FLOPs of a step (``counts.dense_lm_train_flops``: 6 a weight and
token for the products, the unembedding's included, and causal
attention forward and backward; nothing recomputed counted) times the
steps of the unprofiled part of the traced window, over that part's
host-clock seconds."""
from perfbench import counts


def read(ctx):
    w = ctx["window"]
    flops = ctx["facts"].get("step_flops") if w["turns"] else None
    if not flops or not w["window_s"]:
        return None
    return 100 * w["turns"] * flops / w["window_s"] / counts.PEAK_FLOPS["bf16"]
