"""PyTorch + CUDA port of the soft-GPGPU overlay (the JAX package is
``repro``, kept beside it as the reference).

The overlay of the paper: a kernel binary, an ``(n, 10)`` int32 array,
runs through the lockstep SM pipeline (:mod:`repro_torch.core.pipeline`),
and the multi-SM executor (:mod:`repro_torch.runtime.executor`) packs
blocks round-robin over SMs.  On an NVIDIA Hopper card the default
``execute_backend="cuda_fused"`` runs each dispatch group as one
hand-written CUDA kernel; ``device="cpu"`` runs the plain PyTorch
versions.  Nothing here imports ``jax`` or ``repro``.
"""
