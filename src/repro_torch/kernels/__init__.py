"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see ``ops`` for the device dispatch)."""
