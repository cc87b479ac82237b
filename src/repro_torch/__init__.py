"""PyTorch/CUDA port of the Synopses Data Engine (``src/repro``).

Every module sits at the same relative path as the JAX module it is held
against, and its docstring names that counterpart. The port imports
``torch`` and numpy only -- never ``jax`` and nothing of ``repro``.

Design choices shared by every module:

  * Synopsis kinds are frozen dataclasses whose state is a tensor (or a
    dict of tensors, see ``core.batched.tree_map``).
  * State is updated IN PLACE. This replaces the JAX package's buffer
    donation (``donate_argnums=0`` in ``service/engine.py``) and the
    Pallas ``input_output_aliases={0: 0}``.
  * Every entry point takes an explicit ``device``. The engine defaults to
    ``"cuda"`` and raises when no card is present; it never falls back to
    the CPU on its own. Tests pass ``device="cpu"``.
  * The blue-path scatters are hand-written CUDA kernels for Hopper
    (``kernels/csrc``), built with ``nvcc`` at first use. On a CPU tensor a
    wrapper runs its plain PyTorch version instead (``kernels/ref.py``).
"""
