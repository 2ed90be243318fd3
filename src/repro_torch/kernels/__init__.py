"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package compiles nothing and needs no card; the CUDA sources
under ``csrc/`` are built the first time a kernel is launched.
"""
