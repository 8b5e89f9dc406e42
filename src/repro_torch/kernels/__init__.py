"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``ops`` dispatches by device; ``bincount`` (``bincount_tiles`` and
``bincount``), ``bitonic_sort``, ``flash_attention``, ``ssm_scan`` and
``prefix_scan`` hold each kernel's wrapper and plain version; ``ref`` the
oracles; ``_build`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
