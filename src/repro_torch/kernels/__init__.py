"""Kernels (port of ``repro/kernels``): the hand-written Hopper kernels
of the blue path and of the correlation step (``csrc/``), their
wrappers, their plain PyTorch versions (``ref.py``) and the entry points
around them with the update-kernel registry (``ops.py``).
"""
