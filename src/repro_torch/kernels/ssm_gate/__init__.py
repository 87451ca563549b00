"""The Mamba2 block's gate: the D skip, silu(z) and the gated RMSNorm (CUDA
kernel + plain version)."""
