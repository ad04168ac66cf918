"""PyTorch + CUDA port of the ``repro`` stemmer system.

The package mirrors ``repro``'s layout (``core``, ``kernels``, ``serve``,
``launch``) and imports neither jax nor anything of ``repro``. Entry
points take ``device=`` and default to ``"cuda"``: on a CUDA device the
hot path runs the hand-written kernels under ``kernels/csrc/``; on
``device="cpu"`` it runs their plain PyTorch versions.
"""
