"""Numerical primitives and the CUDA kernel wrappers.

``fused_coupling`` and ``fused_mutation`` wrap the hand-written kernels of
``csrc/``; nothing is compiled or loaded until a CUDA tensor reaches one.
"""
