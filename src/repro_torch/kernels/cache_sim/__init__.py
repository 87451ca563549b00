"""Cache-simulation kernels (K1 set-parallel LRU, K2 fused hierarchy)."""
