"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``ops`` dispatches by device; ``bincount`` (``bincount_tiles`` and
``bincount``), ``bitonic_sort``, ``flash_attention``, ``ssm_scan``,
``prefix_scan`` and ``chain`` (``monotone_chain``, the 2-D hull's reducer)
hold each kernel's wrapper and plain version; ``ref`` the oracles;
``_build`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
