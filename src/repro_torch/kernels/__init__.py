"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* :mod:`.simt_alu` — the execute-stage kernel (``csrc/simt_alu.cu``);
* the fused SM kernel's wrapper lives with its stage,
  :mod:`repro_torch.core.pipeline.fused` (``csrc/fused_sm.cu``);
* :mod:`.ref` — the plain versions;
* :mod:`._build` — the ``nvcc`` build, the loader and the launch counts.
"""
