"""Small-table lookups without gathers.

For the tiny tables a scene carries (media, BSDFs, emitters, shapes — all
O(1..16) rows) an unrolled select chain replaces `jnp.take`: it fuses into
the surrounding elementwise kernel, where a gather is a separate
operation with its own round trip through device memory. This mirrors
how the reference keeps per-plugin parameters in pointer-chased objects:
the array-program equivalent of "cheap field access" is constant-folded
selects, not memory gathers.

Semantics: identical to `jnp.take(table, idx, axis=0)` for idx in
[0, len(table)); out-of-range indices return row 0 (callers that rely on
clipping semantics should clip first, as they must for jnp.take anyway).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Above this row count the select chain's linear cost approaches the fixed
# gather cost; fall back to the hardware gather.
_MAX_UNROLL = 16


def take(table, idx, max_unroll: int = _MAX_UNROLL):
    """Row lookup `table[idx]` (axis 0) via an unrolled select chain when the
    table is small, else `jnp.take`."""
    n = table.shape[0]
    if n > max_unroll:
        return jnp.take(table, idx, axis=0)
    idx = jnp.asarray(idx)
    if n == 1:
        return jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    expand = (...,) + (None,) * (table.ndim - 1)
    acc = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    for k in range(1, n):
        acc = jnp.where((idx == k)[expand], table[k], acc)
    return acc


def onehot_take(table, idx):
    """Row lookup via a one-hot matmul, for mid-size tables (32..1024
    rows). Exactness: the one-hot matrix is exact 0/1 and each output
    element is a single product, so HIGHEST precision reconstructs the f32
    row to ~1 ulp. Out-of-range indices return zeros."""
    n = table.shape[0]
    tab2d = table.reshape(n, -1)
    oh = (idx[:, None] == jnp.arange(n, dtype=idx.dtype)[None, :]).astype(
        jnp.float32)
    out = jax.lax.dot_general(
        oh, tab2d.astype(jnp.float32), (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(idx.shape + table.shape[1:])


def take3(table, idx):
    """`take_along_axis` over a trailing size-3 channel axis without the
    gather: table (..., 3), idx (...) in {0,1,2}."""
    return jnp.where(
        idx == 0, table[..., 0], jnp.where(idx == 1, table[..., 1], table[..., 2])
    )
