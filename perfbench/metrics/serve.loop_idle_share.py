"""The share of the serving window in which the serving loop waited for
work, in %: the program's ``loop.idle`` spans (the loop's thread: each
wait for a submit, each linger) summed over the unprofiled part of the
traced window, over that window and the drain after it.

An approximation that reads a little high: the spans are those of the
tracer's whole time on, which also holds the window's set-up before its
first instant (building the schedule, a metrics reset, a sync), while
the loop waits for work; ``scripts/trace_overhead_ab.py`` gives the
share over both."""


def read(ctx):
    w = ctx["window"]
    spans = w["spans"].get("loop.idle", [])
    if not spans or "drain_s" not in w:
        return None
    whole = w["window_s"] + w["drain_s"]
    return 100 * sum(spans) / whole if whole > 0 else None
