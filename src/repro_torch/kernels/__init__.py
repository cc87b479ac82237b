"""Kernels (port of ``repro/kernels``): the hand-written Hopper kernels
of the blue path (``csrc/``), their wrappers, their plain PyTorch
versions (``ref.py``) and the update-kernel registry (``ops.py``).
"""
