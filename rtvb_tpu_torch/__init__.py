"""rtvb_tpu_torch — Real-Time Voxel Blocks on PyTorch + CUDA (Hopper).

The PyTorch port of the ``rtvb_tpu`` engine.  The JAX package stays the
reference; this package mirrors its layout (``core/``, ``ops/``, ``world/``,
``assets/``, ``render/``) and function names so every counterpart is easy to
find.  Each TPU (Pallas) kernel on the real-time frame's path is a CUDA C++
kernel in ``csrc/``, built on first use for ``sm_90a`` and bound with
ctypes (``rtvb_tpu_torch.kernels``); every kernel's module also holds a
plain PyTorch version that the wrapper runs for CPU tensors only.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
