"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
their plain PyTorch versions, and the plain oracles (``ref.py``)."""
