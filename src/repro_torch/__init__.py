"""PyTorch / CUDA port of the AMC reproduction (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s module tree; each module is held against
the module at the same relative path there.  It imports ``torch`` and
numpy, never JAX or ``repro``.  Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``, where every kernel runs its
plain PyTorch version.  The cache-simulation kernels (K1 ``lru_hits``, K2
``fused_levels``) are hand-written CUDA under ``kernels/cache_sim/csrc``.
"""
