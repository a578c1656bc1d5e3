"""Dynamic-energy proxy model (paper §5.1.2 / Tables 4-6; port of
``repro.core.energy``, numpy, a copy with its imports pointed at the
port).

On an FPGA the paper measures dynamic power with XPower and multiplies by
execution time.  On our substrate we can't meter joules, so we replace
the meter with a deterministic *activity-based* model — the standard
architecture-evaluation approach: every unit event (ALU op, multiply,
register-file access, memory access, instruction fetch/decode, warp-stack
operation) carries an energy weight, and idle-but-present units leak a
per-cycle clock-tree cost.  The weights are relative (unitless "energy
units"); all paper comparisons are ratios, which is what we reproduce:

* FlexGrip vs MicroBlaze (Table 5): the SM fetches/decodes once per warp
  issue while a scalar core fetches per (thread × instruction) — the
  instruction-memory amortization the paper names — plus the SM finishes
  in far fewer cycles, shrinking the cycle-proportional component.
* customization (Table 6): removing the multiplier and shrinking the
  warp stack removes those units' idle per-cycle cost.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from . import isa
from .machine import MachineConfig
from .microblaze import SCALAR_CPI, SCALAR_THREAD_OVERHEAD, classify
from .scheduler import GridResult

# Per-event energy weights (relative units).
E_EVENT = {
    "alu": 1.0,          # 32-bit integer ALU op, one lane
    "mul": 4.0,          # DSP multiply, one lane
    "pred": 1.0,         # ISETP flag generation, one lane
    "gmem": 24.0,        # global (DDR/AXI) access, one lane
    "smem": 3.0,         # BRAM shared access, one lane
    "bra": 1.5,          # branch resolution, one lane
    "ctrl": 0.5,
    "regread": 0.4,      # register-file port access, one lane
    "regwrite": 0.5,
    "fetch": 8.0,        # instruction fetch+decode, once per issue
    "stack": 2.0,        # warp-stack push/pop
}
# Per-cycle idle (clock-tree) cost of present units, per SM.
E_IDLE = {
    "sp_lane": 0.020,          # per scalar processor
    "mul_lane": 0.012,         # per SP multiplier lane, if present
    "third_port_lane": 0.006,  # per SP third-operand read port, if present
    "stack_entry": 0.0035,     # per warp-stack entry across 8 warps
    "base": 0.40,              # scheduler/decoder/regfile clocking
}

# register ports exercised per instruction class (reads, writes)
_REG_PORTS = {
    "alu": (2, 1), "mul": (3, 1), "pred": (2, 0), "gmem": (2, 1),
    "smem": (2, 1), "bra": (0, 0), "ctrl": (0, 0),
}


@dataclasses.dataclass
class EnergyReport:
    total: float
    by_component: Dict[str, float]

    def __str__(self):
        parts = ", ".join(f"{k}={v:,.0f}" for k, v in
                          sorted(self.by_component.items(),
                                 key=lambda kv: -kv[1]))
        return f"E={self.total:,.0f} eu ({parts})"


def activity_energy(op_issues, op_lanes, stack_ops: float,
                    kernel_cycles: float, cfg: MachineConfig,
                    n_sm: int = 1) -> EnergyReport:
    """Dynamic energy of an observed *activity vector* — the raw
    ``(NUM_OPCODES,)`` issue/lane counts plus warp-stack operations and
    the kernel makespan in cycles — on the configured SM(s).

    This is the pricing primitive behind :func:`simt_energy` (one
    launch); the JAX package's serving profiler prices its per-tenant
    aggregates with it too, so the two can never disagree on the model.
    """
    comp: Dict[str, float] = {k: 0.0 for k in
                              ("alu", "mul", "gmem", "smem", "bra", "pred",
                               "ctrl", "regfile", "fetch", "stack", "idle")}
    for op in range(isa.NUM_OPCODES):
        lanes = float(op_lanes[op])
        issues = float(op_issues[op])
        cls = classify(op)
        comp[cls] += lanes * E_EVENT[cls]
        rr, rw = _REG_PORTS[cls]
        comp["regfile"] += lanes * (rr * E_EVENT["regread"] +
                                    rw * E_EVENT["regwrite"])
        comp["fetch"] += issues * E_EVENT["fetch"]
    comp["stack"] += float(stack_ops) * E_EVENT["stack"]

    idle_per_cycle = n_sm * (
        E_IDLE["base"]
        + cfg.n_sp * E_IDLE["sp_lane"]
        + (cfg.n_sp * E_IDLE["mul_lane"] if cfg.enable_mul else 0.0)
        + (cfg.n_sp * E_IDLE["third_port_lane"]
           if cfg.num_read_operands >= 3 else 0.0)
        + 8 * cfg.warp_stack_depth * E_IDLE["stack_entry"])
    comp["idle"] = float(kernel_cycles) * idle_per_cycle
    return EnergyReport(sum(comp.values()), comp)


def simt_energy(res: GridResult, cfg: MachineConfig,
                n_sm: int = 1) -> EnergyReport:
    """Dynamic energy of a grid execution on the configured SM(s)."""
    return activity_energy(res.op_issues, res.op_lanes, res.stack_ops,
                           res.sm_cycles(n_sm), cfg, n_sm)


def scalar_energy(res: GridResult, n_threads: int) -> EnergyReport:
    """MicroBlaze-model dynamic energy for the same dynamic work."""
    comp: Dict[str, float] = {k: 0.0 for k in
                              ("alu", "mul", "gmem", "smem", "bra", "pred",
                               "ctrl", "regfile", "fetch", "idle")}
    cycles = float(n_threads) * SCALAR_THREAD_OVERHEAD
    comp["fetch"] += float(n_threads) * SCALAR_THREAD_OVERHEAD * \
        E_EVENT["fetch"] * 0.125  # thread bookkeeping is simple ALU work
    for op in range(isa.NUM_OPCODES):
        if op in (isa.SSY, isa.BAR, isa.NOP):
            continue  # no scalar equivalent
        lanes = float(res.op_lanes[op])
        cls = classify(op)
        comp[cls] += lanes * E_EVENT[cls]
        rr, rw = _REG_PORTS[cls]
        comp["regfile"] += lanes * (rr * E_EVENT["regread"] +
                                    rw * E_EVENT["regwrite"])
        # the scalar core fetches and decodes EVERY dynamic instruction
        comp["fetch"] += lanes * E_EVENT["fetch"]
        cycles += lanes * SCALAR_CPI[cls]
    # MicroBlaze idle: one lane, no mul array, no warp stacks
    comp["idle"] = cycles * (E_IDLE["base"] * 0.5 + E_IDLE["sp_lane"])
    return EnergyReport(sum(comp.values()), comp)


def scalar_model_cycles(res: GridResult, n_threads: int) -> float:
    cycles = float(n_threads) * SCALAR_THREAD_OVERHEAD
    for op in range(isa.NUM_OPCODES):
        if op in (isa.SSY, isa.BAR, isa.NOP):
            continue
        cycles += float(res.op_lanes[op]) * SCALAR_CPI[classify(op)]
    return cycles
