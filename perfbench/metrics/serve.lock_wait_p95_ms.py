"""The 95th percentile of a submit's wait for the serving loop's lock, in
ms: the program's ``loop.lock-wait`` spans (the client's thread, from the
call to ``ServingLoop.submit`` until the lock is held) over the
unprofiled part of the traced window, by the nearest rank."""
from perfbench import harness as H


def read(ctx):
    spans = ctx["window"]["spans"].get("loop.lock-wait", [])
    return 1e3 * H.quantile(spans, 0.95) if spans else None
