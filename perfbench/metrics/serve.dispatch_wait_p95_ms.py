"""The 95th percentile of a launch's wait inside its window, from packed
to its sub-batch's dispatch, in ms: the program's ``dispatch-wait`` spans
over the unprofiled part of the traced window, by the nearest rank."""
from perfbench import harness as H


def read(ctx):
    spans = ctx["window"]["spans"].get("dispatch-wait", [])
    return 1e3 * H.quantile(spans, 0.95) if spans else None
