"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version beside it (``<kernel>/ref.py``)."""
