"""K4: AMC recorded-stream gather (CUDA kernels + plain versions)."""
