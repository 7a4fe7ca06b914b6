"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Same module layout and names as the JAX package; imports torch and never
JAX or the JAX package.
"""
