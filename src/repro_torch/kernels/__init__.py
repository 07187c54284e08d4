"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain PyTorch
versions; ``ops`` holds the entry points the models call."""
