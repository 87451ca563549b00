"""K6: the Mamba2 SSD chunk scan (CUDA kernel + plain versions)."""
