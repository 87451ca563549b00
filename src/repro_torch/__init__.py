"""PyTorch / CUDA port of the AMC reproduction (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s module tree; each module is held against
the module at the same relative path there.  It imports ``torch`` and
numpy, never JAX or ``repro``.  Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``, where every kernel runs its
plain PyTorch version.  The kernels are hand-written CUDA, each under its
module's ``csrc/``: the cache-simulation kernels (K1 ``lru_hits``, K2
``fused_levels``), the BaseΔ tile kernels (K3), the AMC gather kernels
(K4), and the LM serving path's blocked attention (K5 ``flash_attention``)
and Mamba2 SSD scan (K6 ``ssd_scan``).  The paper's evaluation grid runs
through ``repro_torch.core.Experiment``, as through ``repro.core.Experiment``.
"""
