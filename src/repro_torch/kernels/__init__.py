"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``ops`` dispatches by device; ``bincount``, ``bitonic_sort`` and
``flash_attention`` hold each kernel's wrapper and plain version; ``ref``
the oracles; ``_build`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
