"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Counterpart of ``src/repro/kernels/``.  Sources are under ``csrc/``; they are
built at first use (``_build.py``), never at import.  ``ops.py`` holds the
public entry points.
"""
