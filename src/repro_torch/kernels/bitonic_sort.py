"""Row-wise key-value sort — the tile-local sort of the multi-tile radix
shuffle (:mod:`repro_torch.core.kshuffle`).

``bitonic_sort(keys, values)`` sorts each row of a (rows, n) int32 or
float32 key matrix ascending and permutes a same-shape 4-byte value matrix
along.  Rows are padded to a power of two n_pad with the key type's maximum;
a row with n_pad above 2^18 raises, as the JAX package's kernel does.

:func:`bitonic_sort_cuda` launches the hand-written bitonic network of
``csrc/bitonic_sort.cu``, run in registers; :func:`bitonic_sort_plain` is
the plain PyTorch version (stable argsort plus gather) for the CPU and as
the kernel's yardstick on the card; :func:`bitonic_sort_meta` allocates
the outputs on the meta device, for a dry run; :func:`bitonic_sort_work`
gives a call's operations and bytes.  The network is not stable, so the two
agree exactly on rows of unique keys, which is what the shuffle sorts
(segmented keys ``dest * tile + local_src``).
:func:`repro_torch.kernels.ops.bitonic_sort` picks one by device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

#: launches of the CUDA kernel since the last reset (ops.reset_launches)
launches = 0

#: widest padded row the function accepts (the JAX kernel's per-grid-step
#: VMEM budget, kept as the contract)
_ROW_BLOCK_ELEMS = 1 << 18
_KEY_DTYPES = (torch.int32, torch.float32)


def _check_pair(keys: torch.Tensor, values: torch.Tensor) -> None:
    if keys.shape != values.shape or keys.ndim != 2:
        raise ValueError("bitonic_sort expects matching (rows, n) arrays")


def _padded_width(n: int) -> int:
    n_pad = 1
    while n_pad < n:
        n_pad *= 2
    if n_pad > _ROW_BLOCK_ELEMS:
        raise ValueError(
            f"bitonic_sort: one row of n={n} (padded {n_pad}) exceeds the "
            f"single-VMEM-tile budget ({_ROW_BLOCK_ELEMS}); split the row "
            f"into tiles first (see repro_torch.core.kshuffle)")
    return n_pad


def bitonic_sort_plain(keys: torch.Tensor, values: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: stable argsort of each row, then gather.

    It agrees with the network (the CUDA kernel, and the JAX package's
    Pallas kernel) on rows of unique finite keys, and differs elsewhere:

    - tied keys keep their values in row order here, where the network
      leaves them in its own order (keys [1, 1, 1, 0] with values
      [0, 1, 2, 3]: [3, 0, 1, 2] here, [3, 0, 2, 1] from the JAX kernel);
    - a ``+inf`` key stays here, where the network pads a row that is not
      a power of two wide with the key type's maximum, sorts the ``+inf``
      past the padding and cuts it off (the row [inf, 1, 2] gives keys
      [1, 2, 3.4e38] with a padding value in place of the ``+inf`` key's);
    - NaN keys go last here, where the network's comparisons leave a row
      holding a NaN unsorted.

    The shuffle sorts unique int32 keys below the padding, so none of this
    reaches an engine's output."""
    _check_pair(keys, values)
    if keys.numel() == 0:
        return keys, values
    _padded_width(keys.shape[1])
    order = torch.argsort(keys, dim=-1, stable=True)
    return keys.gather(-1, order), values.gather(-1, order)


def bitonic_sort_work(rows: int, n: int, key_dtype, value_dtype
                      ) -> Tuple[int, int]:
    """(operations, bytes) of one call: keys and values read once and
    written once; the network's compare-exchanges, n_pad / 2 for each of
    its L (L + 1) / 2 stages (n_pad = 2^L the padded width)."""
    n_pad = 1 << max(0, (n - 1).bit_length())
    L = n_pad.bit_length() - 1
    return (rows * (n_pad // 2) * L * (L + 1) // 2,
            2 * rows * n * (key_dtype.itemsize + value_dtype.itemsize))


def bitonic_sort_cuda(keys: torch.Tensor, values: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bitonic_sort.cu`` on CUDA tensors; raises on any
    failure to build or launch."""
    return _sort(keys, values, "cuda")


def bitonic_sort_meta(keys: torch.Tensor, values: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The meta route: checks the rows and allocates the outputs as
    :func:`bitonic_sort_cuda` does on meta tensors; the work rows of rows
    wider than the built library's shared-memory width are left out."""
    return _sort(keys, values, "meta")


def _sort(keys, values, device_type: str):
    global launches
    _check_pair(keys, values)
    if keys.device.type != device_type or values.device != keys.device:
        raise ValueError(f"bitonic_sort_{device_type} takes "
                         f"{device_type.upper()} tensors on one device")
    if keys.dtype not in _KEY_DTYPES or values.element_size() != 4:
        raise ValueError(f"bitonic_sort_{device_type} takes int32 or "
                         f"float32 keys and 4-byte values, got {keys.dtype} "
                         f"and {values.dtype}")
    rows, n = keys.shape
    if rows == 0 or n == 0:
        return keys, values
    n_pad = _padded_width(n)
    # the kernel moves rows in 16-byte words
    keys, values = (t.contiguous() for t in (keys, values))
    keys, values = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (keys, values))
    out_k, out_v = torch.empty_like(keys), torch.empty_like(values)
    if device_type == "meta":
        return out_k, out_v
    lib = _build.library()
    work_k = work_v = None
    if n_pad > lib.repro_bitonic_smem_width():
        work_k = torch.empty((rows, n_pad), dtype=keys.dtype, device=keys.device)
        work_v = torch.empty((rows, n_pad), dtype=values.dtype,
                             device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = lib.repro_bitonic_sort(
        keys.data_ptr(), values.data_ptr(), out_k.data_ptr(), out_v.data_ptr(),
        None if work_k is None else work_k.data_ptr(),
        None if work_v is None else work_v.data_ptr(),
        rows, n, n_pad, int(keys.dtype == torch.float32), stream)
    _build.check(err, "bitonic_sort")
    launches += 1
    return out_k, out_v


def bitonic_sort(keys: torch.Tensor, values: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row of (rows, n) keys sorted ascending, values moved along: the
    JAX module's public name, the device dispatch of
    :func:`repro_torch.kernels.ops.bitonic_sort` (imported at the call:
    ``ops`` imports this module), so a launch is counted once."""
    from . import ops
    return ops.bitonic_sort(keys, values)
