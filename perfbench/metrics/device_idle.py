"""The share of the profiled part of the window in which no operation
ran on the device, in %.  Reads ``device_idle.<cell kind>`` for every
cell: the harness falls back to this file for each such name."""


def read(ctx):
    p = ctx["profile"]
    return 100 * (1 - p["busy_s"] / p["window_s"]) if p["window_s"] else None
