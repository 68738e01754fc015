"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper, slice by slice.

Same layout as ``src/repro/``: ``core/``, ``kernels/``, ``models/``,
``configs/``, ``data/``, ``serving/``, ``training/``, ``launch/``.  Imports
``torch``; never ``jax`` and nothing of ``repro``.  Ported so far: the LLM
ORDER BY operator (``core/``: access paths, probe-plan executor, optimizer,
oracles), the serving path (``LM`` -> ``KVBlockPool`` -> ``ServeEngine`` ->
``BatchScheduler``), every block kind but the encoder-decoder's, training
(``LM.loss`` -> ``Trainer`` -> checkpoints), the single-device serving and
training launchers, and all eight kernels.  Entry points run on the GPU
unless ``device="cpu"`` is passed.
"""
