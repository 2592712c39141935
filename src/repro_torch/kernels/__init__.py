"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside it (counterpart of ``repro.kernels``).  Nothing here builds
or imports a compiler at import time: ``_build`` compiles at first launch.
"""
