"""The serving step (port of ``repro.launch.steps.build_serve_step``).

The JAX package jits the step with shardings over a device mesh and
donates the decode state; here the step runs eagerly on one device under
``torch.inference_mode()`` and writes the KV caches in place.
"""
from __future__ import annotations

import torch

from ..configs import ArchSpec
from ..models import api


def build_serve_step(spec: ArchSpec):
    """Returns ``serve_step(params, state, tokens, cache_index) ->
    (next_tok, state)``: one step over (B, S) tokens at ``cache_index``
    and the greedy next token (B,) int32 of its last position.  S > 1 at
    index 0 is the prefill, S = 1 one decode step."""

    def serve_step(params, state, tokens, cache_index):
        with torch.inference_mode():
            logits, new_state = api.apply_decode(params, spec, tokens,
                                                 state, cache_index)
            next_tok = logits[:, -1].argmax(-1).to(torch.int32)
        return next_tok, new_state

    return serve_step
