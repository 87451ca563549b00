"""K5: blocked causal / sliding-window attention (CUDA kernel + plain
versions)."""
