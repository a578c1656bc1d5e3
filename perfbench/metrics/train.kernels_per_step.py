"""Kernels the device ran a training step: the kernels in the profiled
steps' trace (copies and fills left out) over those steps."""


def read(ctx):
    p = ctx["profile"]
    n = sum(cnt for name, (_, cnt) in p["kernels"].items()
            if not name.startswith(("Memcpy", "Memset")))
    return n / p["turns"] if n and p["turns"] else None
