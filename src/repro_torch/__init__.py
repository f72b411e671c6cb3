"""PyTorch/CUDA port of the FTPipeHD reproduction in ``src/repro/``.

The package mirrors ``src/repro/`` module for module and imports neither
JAX nor the reference package. Entry points compute on CUDA unless the
caller passes ``device="cpu"``; the fused-SGD update runs as a hand-written
CUDA kernel (``csrc/fused_sgd.cu``).
"""
