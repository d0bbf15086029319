"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel.

Each kernel package holds ``csrc/*.cu`` (the CUDA C++ source, built by
``_build`` with nvcc at first use and loaded through ctypes), ``ops.py`` (the
wrapper: checks, allocation, launch on the current stream, launch count) and
``ref.py`` (the plain PyTorch version, which the wrapper runs for CPU
tensors and the tests hold the kernel against).
"""
