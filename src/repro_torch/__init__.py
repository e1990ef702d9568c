"""PyTorch/CUDA port of the AIA reproduction (the JAX package ``repro``
is the reference).

Layout mirrors the reference: ``core`` (threefry bits, fixed point, IU
LUT, Knuth-Yao walk), ``kernels`` (hand-written CUDA kernels for Hopper
and their plain PyTorch versions), ``pgm`` (Bayes-net IR, coloring,
compiler chain, diagnostics) and ``serve`` (the posterior query engine).
Entry points run on the card (``cuda``) unless the caller asks for the
CPU; results match the reference bit for bit under the same seed.
"""
