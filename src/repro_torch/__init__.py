"""PyTorch/CUDA port of the multiplierless in-filter classifier.

A second package beside the JAX reference ``repro``: the same modules
(``core``, ``kernels``, ``configs``, ``serving``, ``models``, ``optim``,
``distributed``, ``launch``), written in PyTorch, with every TPU kernel on
the ported path replaced by a CUDA kernel written by hand for Hopper
(``kernels/csrc``). It imports neither JAX nor ``repro``.
Entry points run on the card unless given ``device="cpu"``.
"""
