"""The 95th percentile of a launch's run, from its sub-batch's dispatch
to its completion, in ms: the program's ``launch-run`` spans over the
unprofiled part of the traced window, by the nearest rank."""
from perfbench import harness as H


def read(ctx):
    spans = ctx["window"]["spans"].get("launch-run", [])
    return 1e3 * H.quantile(spans, 0.95) if spans else None
