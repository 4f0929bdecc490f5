"""PyTorch port of the CycleSL package ``repro``, for NVIDIA Hopper cards.

The layout mirrors ``repro`` module for module.  Entry points run on the
card unless the caller asks for the CPU; on the CPU every kernel wrapper
runs its plain PyTorch version.
"""
