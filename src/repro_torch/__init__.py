"""PyTorch/CUDA port of the ``repro`` package.

The layout mirrors ``repro`` module for module, so each module here has a
counterpart of the same path there. The port imports ``torch`` and never
``jax`` or anything of ``repro``; where it needs a numpy-only module of the
JAX package it keeps its own copy.

Slices ported so far, on a (1, 1, 1, 1) mesh: continuous-batching
serving of dense all-attention decoders (``launch/serve.py --mode
continuous``), training on one card (``launch/train.py``), and fixed-batch
serving (``launch/serve.py --mode fixed``) of those decoders and of Jamba's
hybrid Mamba/attention decoder with dense FFNs; and context-parallel
training on a (1, 1, 1, 1, g_seq) mesh, one gloo rank per seq shard
(``launch/train.py --mesh 1,1,1,1,2`` under ``torch.distributed.run``).
Every kernel on these paths
is written by hand for Hopper (``kernels/``). ROADMAP.md lists what is
still to port.
"""
