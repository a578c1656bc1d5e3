"""flexgrip — the paper's own soft-GPGPU overlay configuration (§3/T1)."""
from repro_torch.configs import ArchSpec
from repro_torch.core.machine import MachineConfig

CFG = MachineConfig(n_sp=8, n_regs=16, warp_stack_depth=32,
                    enable_mul=True, num_read_operands=3)
SPEC = ArchSpec(name="flexgrip", family="overlay", cfg=CFG,
                skips={k: "overlay arch: uses the SIMT benchmark suite, "
                          "not LM shapes"
                       for k in ("train_4k", "prefill_32k", "decode_32k",
                                 "long_500k")},
                source="ICFPT'13 / CS.AR'16 (this paper)")
