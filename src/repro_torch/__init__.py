"""PyTorch/CUDA port of the Infinite-LLM reproduction.

A second package beside the JAX reference ``repro``: same subpackage
layout and names (``configs``, ``core``, ``kernels``, ``models``,
``serving``), PyTorch idiom inside, hand-written CUDA kernels for the
paged MicroAttention partials. It imports nothing of JAX or of ``repro``.
"""
