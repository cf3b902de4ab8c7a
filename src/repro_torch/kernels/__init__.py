"""Hand-written CUDA kernels (sm_90a) for the serving path, their plain
PyTorch versions (`ref`), and the device dispatch (`ops`).

Each kernel module imports nothing CUDA-specific at import time: the
shared library is built with ``nvcc`` on first launch (`build`)."""
