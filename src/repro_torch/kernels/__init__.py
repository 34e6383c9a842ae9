"""Hand-written CUDA kernels of the port, each beside its plain
PyTorch version; ``ops`` dispatches on the tensor's device."""
