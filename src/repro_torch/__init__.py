"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper, slice by slice.

Same layout as ``src/repro/``: ``core/``, ``kernels/``, ``models/``,
``configs/``, ``data/``, ``serving/``, ``launch/``.  Imports ``torch``; never
``jax`` and nothing of ``repro``.  Ported so far: the LLM ORDER BY operator
(``core/``: access paths, probe-plan executor, optimizer, oracles), the
serving path (``LM`` -> ``KVBlockPool`` -> ``ServeEngine`` ->
``BatchScheduler``) for pure full-attention stacks, the single-device serving
launcher, and three attention kernels (paged decode, flash prefill, dense
decode).  Entry points run on the GPU unless ``device="cpu"`` is passed.
"""
