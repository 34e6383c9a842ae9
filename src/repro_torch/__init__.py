"""PyTorch/CUDA port of the ``repro`` serving stack.

The package mirrors ``repro``'s layout (``core``, ``configs``, ``quant``,
``kernels``, ``models``, ``serve``, ``launch``) and imports neither JAX
nor ``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the two hand-written CUDA kernels (paged decode
attention, dequantizing matmul) launch on CUDA tensors, and their plain
PyTorch versions serve CPU tensors.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
