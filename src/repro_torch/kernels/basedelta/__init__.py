"""K3: BaseΔ compression of AMC entry tiles (CUDA kernels + plain versions)."""
