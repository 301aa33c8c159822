"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the dispatchers that route between them (``ops``)."""
