"""Hand-written Hopper kernels (``csrc/``), their wrappers and their plain
PyTorch versions."""
