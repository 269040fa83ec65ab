"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
(``ops``), their plain torch versions (``ref``) and the builder
(``build``)."""
