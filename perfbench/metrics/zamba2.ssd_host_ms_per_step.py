"""Host milliseconds a training step spends in the program's chunked SSD
scans: the ``mamba2.ssd`` spans (``obs/trace.TRACER``, host spans with no
device sync: the Python chunk loop's launches, in the forward and in the
remat's recompute), summed over the unprofiled part of the traced window
and divided by its steps."""


def read(ctx):
    w = ctx["window"]
    spans = w["spans"].get("mamba2.ssd", [])
    if not spans or not w["turns"]:
        return None
    return 1e3 * sum(spans) / w["turns"]
