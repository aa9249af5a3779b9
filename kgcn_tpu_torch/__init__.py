"""kgcn_tpu_torch — the PyTorch/CUDA port of kgcn_tpu for NVIDIA Hopper.

Mirrors the layout of ``kgcn_tpu`` module for module.  Imports torch, numpy,
scipy and the standard library only, never JAX or ``kgcn_tpu``.  Entry
points run on the GPU unless the caller asks for the CPU.
"""
