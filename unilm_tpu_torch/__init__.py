"""unilm_tpu_torch — the PyTorch/CUDA port of unilm_tpu.

The JAX package `unilm_tpu/` is the reference; this package mirrors its
layout (core/, ops/, models/, runtime/, convert/) and keeps its public
tensor layouts ([B, T, H, D] attention inputs, flat [P, page, H*D] KV
pools, the same cache leaf names) so each module can be held against its
JAX counterpart output for output. Kernels that the JAX package wrote in
Pallas are hand-written CUDA C++ for Hopper (sm_90a) under csrc/, built
with nvcc at first use into `_build/` and bound with ctypes. Each kernel
wrapper keeps its plain PyTorch twin in the same module; the twin runs
only for tensors that live on the CPU.

This package imports torch and numpy only — never jax, flax or unilm_tpu.
"""

__all__ = ["core", "ops", "models", "runtime", "convert"]
