"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: one command runs one cell of ``BENCHMARK.json`` once.
See ``portbench/README.md``."""
