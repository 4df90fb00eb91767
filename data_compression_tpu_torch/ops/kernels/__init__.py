"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the wrapper (which launches the kernel on a CUDA
tensor, keeps a ``launches`` count, and takes the plain version only for
a CPU tensor) and the plain PyTorch version ``*_ref`` beside it.
"""
