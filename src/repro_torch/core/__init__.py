"""The soft-GPGPU machine: ISA, assembler, paper programs, SM pipeline."""
