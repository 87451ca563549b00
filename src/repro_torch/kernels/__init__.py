"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live under each kernel's ``csrc/`` and are built at first
use by :mod:`repro_torch.kernels.build`."""
