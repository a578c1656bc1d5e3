"""The paper's five programs in one batch, and a digest of everything an
``execute`` of them gives: every gmem word and counter of each launch and
the per-SM cycles.  ``PINNED_N64`` is the digest of the JAX package's
``execute`` of ``five_programs(64)`` on 2 SMs at its default chunk;
``tests/test_torch_dispatch.py`` holds the pin to the JAX package on the
CPU, and ``tests/test_torch_cuda.py`` holds the card's widest dispatch
group to it without importing JAX."""
import hashlib

import numpy as np

from repro_torch.core.programs import ALL

#: sha256 of :func:`digest` of the JAX package's ``execute`` of
#: ``five_programs(64)`` on 2 SMs at its default chunk
PINNED_N64 = ("7d188c22f00f57fa742b28bfae1e742a"
              "6a44d355356e7a6519fa76da6a1bbc52")


def five_programs(n):
    """(code, grid, block_dim, gmem) of each paper program at ``n``, in
    name order, each gmem drawn from its own seed."""
    out = []
    for i, name in enumerate(sorted(ALL)):
        mod = ALL[name]
        grid, bd = mod.launch(n)
        out.append((mod.build(n), grid, bd,
                    mod.make_gmem(np.random.default_rng(64 + i), n)))
    return out


def digest(results, per_sm_cycles) -> str:
    """sha256 over each result's fields (gmem, cycles per block, opcode
    issues and lanes, stack ops, max sp, overflow) and the per-SM
    cycles, each as int64."""
    h = hashlib.sha256()
    for r in results:
        for f in ("gmem", "cycles_per_block", "op_issues", "op_lanes",
                  "stack_ops", "max_sp", "overflow"):
            h.update(np.asarray(getattr(r, f)).astype(np.int64).tobytes())
    h.update(np.asarray(per_sm_cycles).astype(np.int64).tobytes())
    return h.hexdigest()
