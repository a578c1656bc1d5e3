"""Host milliseconds a dispatch group spends merging its positions'
writes: the program's ``merge`` spans (inside each ``device-execute``)
summed over the unprofiled part of the traced window, over the count of
``device-execute`` spans there."""


def read(ctx):
    spans = ctx["window"]["spans"]
    merge, groups = spans.get("merge", []), spans.get("device-execute", [])
    return 1e3 * sum(merge) / len(groups) if merge and groups else None
