"""Host milliseconds a dispatch group: the mean of the program's
``device-execute`` spans (``obs/trace.TRACER``, host spans with no
device sync) over the unprofiled part of the traced window."""


def read(ctx):
    spans = ctx["window"]["spans"].get("device-execute", [])
    return 1e3 * sum(spans) / len(spans) if spans else None
