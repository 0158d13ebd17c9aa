"""Hand-written Hopper kernels (CUDA C++ under `csrc/`), each beside its plain
PyTorch version. Sources are compiled at first use on a CUDA device
(`_build.py`); importing this package builds nothing."""
