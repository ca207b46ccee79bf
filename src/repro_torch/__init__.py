"""PyTorch/CUDA port of the ``repro`` package.

The layout mirrors ``repro`` module for module, so each module here has a
counterpart of the same path there. The port imports ``torch`` and never
``jax`` or anything of ``repro``; where it needs a numpy-only module of the
JAX package it keeps its own copy.

Slice ported so far: continuous-batching serving of dense all-attention
decoders (``launch/serve.py`` ``--mode continuous``) on a (1, 1, 1, 1)
mesh, with hand-written Hopper kernels for paged attention and RMSNorm
(``kernels/``). ROADMAP.md lists what is still to port.
"""
