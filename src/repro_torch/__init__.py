"""PyTorch/CUDA port of the compressed-resident genomics codec.

Mirrors the JAX package path for path (`repro_torch.core.decoder` is the
counterpart of `repro.core.decoder`). Entry points take `device=` and
default to the CUDA card; `device="cpu"` runs the plain PyTorch versions
of the kernels. The two decode kernels are hand-written CUDA C++ for
Hopper (`csrc/`), built with nvcc at first use.
"""
