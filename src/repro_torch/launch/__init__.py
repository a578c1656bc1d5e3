"""Serving entry points of the port: ``steps`` (the step builder) and
``serve`` (batched prefill, then decode)."""
