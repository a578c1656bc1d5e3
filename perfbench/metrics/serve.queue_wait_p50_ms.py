"""The median wait of a launch in the server's queue, from submit to
pack, in ms: the server's own ``server.queue_wait_s`` histogram over the
unprofiled part of the traced window."""
import math


def read(ctx):
    v = ctx["window"].get("queue_wait_p50_s")
    return None if v is None or math.isnan(v) else 1e3 * v
