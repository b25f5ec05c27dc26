"""The CUDA decode kernels, their plain PyTorch versions and the dispatch."""
