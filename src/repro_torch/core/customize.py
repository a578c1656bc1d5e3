"""Application-class architectural customization (§4 / Table 6; port of
``repro.core.customize``, numpy).

The paper's second contribution: analyze a kernel binary, determine the
minimal architectural configuration that can execute it, and select the
matching pre-built FlexGrip variant (full / reduced warp stack /
stack-less / no-multiplier).  We reproduce the analysis and the variant
catalog; the catalog's configurations are the port's ``MachineConfig``s
(default backend ``"cuda_fused"``).

On the card a variant changes no code: the fused kernel takes
``enable_mul``, ``num_read_operands`` and ``warp_stack_depth`` as run-time
arguments (the warp stack's shared memory shrinks with the depth, nothing
else), and nothing is dead-code-eliminated as XLA does for the JAX
package.  A variant's saving is therefore the one the energy model and the
area proxy (``MachineConfig.lut_bits``) price, Table 6's columns, not a
smaller or faster kernel.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from . import isa
from .machine import MachineConfig


@dataclasses.dataclass(frozen=True)
class ProgramProfile:
    """Static instruction analysis of one kernel binary."""
    uses_mul: bool
    uses_third_operand: bool
    max_ssy_nesting: int       # static bound on RECONV entries
    has_divergent_branches: bool
    opcode_histogram: tuple

    @property
    def required_stack_depth(self) -> int:
        """Static warp-stack bound: each open SSY scope can hold one
        RECONV plus one transient TAKEN entry."""
        if not self.has_divergent_branches and self.max_ssy_nesting == 0:
            return 0
        return 2 * self.max_ssy_nesting


def analyze(code: np.ndarray) -> ProgramProfile:
    code = np.asarray(code)
    ops = code[:, isa.F_OP]
    hist = np.bincount(ops, minlength=isa.NUM_OPCODES)
    uses_mul = bool(hist[isa.IMUL] or hist[isa.IMAD])
    uses_third = bool(hist[isa.IMAD])
    # SSY targets are reconvergence addresses; nesting = max number of SSY
    # scopes simultaneously open at any instruction address.
    open_depth, max_depth = 0, 0
    closes = {}
    for i, row in enumerate(code):
        for tgt, n in list(closes.items()):
            if i == tgt:
                open_depth -= n
                del closes[tgt]
        if row[isa.F_OP] == isa.SSY:
            open_depth += 1
            tgt = int(row[isa.F_IMM])
            closes[tgt] = closes.get(tgt, 0) + 1
            max_depth = max(max_depth, open_depth)
    guarded_bra = bool(np.any((ops == isa.BRA) &
                              ((code[:, isa.F_FLAGS] & isa.FLAG_GUARD) != 0)))
    return ProgramProfile(uses_mul, uses_third, max_depth, guarded_bra,
                          tuple(int(x) for x in hist))


def minimal_config(code: np.ndarray,
                   base: MachineConfig = MachineConfig()) -> MachineConfig:
    """The smallest FlexGrip variant that can run ``code`` (§5.2)."""
    prof = analyze(code)
    depth = max(prof.required_stack_depth, 1)  # zero-size arrays are awkward
    return dataclasses.replace(
        base,
        warp_stack_depth=min(depth, base.warp_stack_depth),
        enable_mul=prof.uses_mul,
        num_read_operands=3 if prof.uses_third_operand else 2)


def validate(code: np.ndarray, cfg: MachineConfig) -> List[str]:
    """Check a binary against an architecture variant; returns problems."""
    prof = analyze(code)
    problems = []
    if prof.uses_mul and not cfg.enable_mul:
        problems.append("program uses IMUL/IMAD but multiplier is removed")
    if prof.uses_third_operand and cfg.num_read_operands < 3:
        problems.append("program uses IMAD but third read port is removed")
    if prof.required_stack_depth > cfg.warp_stack_depth:
        problems.append(
            f"static stack bound {prof.required_stack_depth} exceeds "
            f"warp_stack_depth {cfg.warp_stack_depth}")
    return problems


# The four-bitstream catalog the paper proposes storing in an embedded
# system (§5.2 closing paragraph).
VARIANT_CATALOG = {
    "baseline": MachineConfig(),
    "stack16": MachineConfig(warp_stack_depth=16),
    "stack2": MachineConfig(warp_stack_depth=2),
    "stack2_nomul": MachineConfig(warp_stack_depth=2, enable_mul=False,
                                  num_read_operands=2),
}


def select_variant(code: np.ndarray) -> str:
    """Pick the smallest catalog variant that validates for ``code``."""
    for name in reversed(list(VARIANT_CATALOG)):  # smallest variant first
        if not validate(code, VARIANT_CATALOG[name]):
            return name
    return "baseline"
