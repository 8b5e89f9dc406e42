"""Assertions the parity tests share: boxes and accumulators of either
package, compared exactly on numpy arrays.  Imports no JAX: JAX arrays
convert through ``np.asarray``."""
from __future__ import annotations

import numpy as np

from ._tree import tree_leaves
from .interop import as_numpy as _np


def assert_same_box(ref, got, ctx: str = "") -> None:
    """Same payload leaves (in flattened order) and validity, bit for bit."""
    ref_leaves, got_leaves = tree_leaves(ref.payload), tree_leaves(got.payload)
    assert len(ref_leaves) == len(got_leaves), \
        f"{ctx}: {len(ref_leaves)} payload leaves != {len(got_leaves)}"
    for la, lb in zip(ref_leaves, got_leaves):
        np.testing.assert_array_equal(_np(la), _np(lb), err_msg=ctx)
    np.testing.assert_array_equal(_np(ref.valid), _np(got.valid), err_msg=ctx)


def assert_same_accum(ref, got, ctx: str = "") -> None:
    """Every CostAccum field equal (rounds, communication, internal_time,
    max_reducer_io, dropped)."""
    assert tuple(ref._fields) == tuple(got._fields), ctx
    for name, fa, fb in zip(ref._fields, ref, got):
        assert float(_np(fa)) == float(_np(fb)), \
            f"{ctx}: CostAccum.{name} {fa} != {fb}"


def assert_same_stats(ref, got, ctx: str = "") -> None:
    """Every RoundStats field equal, and int32 on both sides."""
    for name, fa, fb in zip(ref._fields, ref, got):
        a, b = _np(fa), _np(fb)
        assert int(a) == int(b), f"{ctx}: RoundStats.{name} {a} != {b}"
        assert a.dtype == np.int32 and b.dtype == np.int32, \
            f"{ctx}: RoundStats.{name} dtypes {a.dtype}, {b.dtype}"
