"""Kernels (port of ``repro/kernels``): the hand-written Hopper kernels
of the blue path, the correlation step and the attention forward
(``csrc/``), their
wrappers, their plain PyTorch versions (``ref.py``) and the entry points
around them with the update-kernel registry (``ops.py``).
"""
