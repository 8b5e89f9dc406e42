"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``ops`` dispatches by device; ``bincount`` (``bincount_tiles`` and
``bincount``), ``bitonic_sort``, ``flash_attention``, ``ssm_scan``,
``prefix_scan`` and ``chain`` (``monotone_chain``, the 2-D hull's reducer)
hold each kernel's wrapper and plain version; ``ref`` the oracles;
``_build`` compiles ``csrc/*.cu`` with nvcc at first use.

Unlike ``repro.kernels``, whose package names ``bincount``,
``bitonic_sort``, ``flash_attention``, ``prefix_scan`` and ``ssm_scan`` are
the ``ops`` functions, here they stay the kernel modules: the functions are
``ops.<name>`` and ``<module>.<name>``, one dispatch.  ``bincount_tiles``
is the function, as in the JAX package.
"""
from . import bincount, bitonic_sort, chain, flash_attention, ops, \
    prefix_scan, ref, ssm_scan
from .ops import bincount_tiles

__all__ = [
    "bincount", "bincount_tiles", "bitonic_sort", "flash_attention",
    "prefix_scan", "ssm_scan", "ops", "ref",
    # the port's own: the 2-D hull's chain kernel, which has no Pallas
    # counterpart
    "chain",
]
