"""Hand-written Hopper kernels and their plain PyTorch versions.

``ref`` holds the plain versions, ``ops`` the dispatch (kernel for a
CUDA tensor, plain version for a CPU tensor), ``_build`` compiles the
CUDA sources under ``csrc/`` at first use.  Importing this package
builds nothing.
"""
