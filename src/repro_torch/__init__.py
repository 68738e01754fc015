"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper, slice by slice.

Same layout as ``src/repro/``: ``kernels/``, ``models/``, ``configs/``,
``data/``, ``serving/``.  Imports ``torch``; never ``jax`` and nothing of
``repro``.  Ported so far: the serving path (``LM`` -> ``KVBlockPool`` ->
``ServeEngine``) for pure full-attention stacks, with the paged decode
attention kernel.  Entry points run on the GPU unless ``device="cpu"`` is
passed.
"""
