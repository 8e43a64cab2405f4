"""Stream compaction: gather-index computation for keep-masks.

The mining wavefront compacts surviving children / gated outputs into
dense arrays every level.  PRODUCTION PATH: `compact_kidx_sort` — one
`lax.sort` whose keys are the element indices where kept and n (sorts
last) where dropped, so the sorted prefix IS the compaction index list.
Its cost on the GPU against a sort-free compaction (prefix sums + one
scatter) is not yet measured.

RETAINED ALTERNATIVE: `compact_kidx` computes the same indices the way
an FM-index answers select queries — pack the keep mask into uint32
words, popcount + prefix-sum the per-word counts, invert the (sorted)
word-offset map with a scatter-max plus a cummax, then two 1-D gathers
from word-count-sized tables and a 5-step branchless in-word bit
select.  It avoids sorting entirely; both paths are differentially tested
against the NumPy oracle (tests/test_compact.py).

Used by the device mining episode (mining/engine_device.py); the
reference's equivalent moment is the implicit "append surviving child
to the DFS stack" in EnumerateQuery.cpp:184-222.
"""

from __future__ import annotations

import numpy as np

BLK = 32  # bits per select block = one packed uint32 word


def compact_kidx(mask, width: int):
    """Indices of the set bits of `mask`, compacted to the front.

    mask: bool (N,) with N a multiple of 32.
    width: static output length (must be >= the true popcount whenever
      the caller reads that many entries; extra slots hold in-range
      garbage indices).

    Returns (kidx int32 (width,), count int32 scalar): kidx[j] = index of
    the j-th set bit for j < count; garbage (but in [0, N)) beyond.
    """
    import jax.numpy as jnp
    from jax import lax

    n = mask.shape[0]
    assert n % BLK == 0, "mask length must be a multiple of 32"
    nw = n // BLK
    assert width <= n

    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    words = (jnp.where(mask.reshape(nw, 32), weights[None, :], jnp.uint32(0))
             .sum(axis=1, dtype=jnp.uint32))                     # (nw,)
    cntw = lax.population_count(words).astype(jnp.int32)
    incw = jnp.cumsum(cntw)
    offw = incw - cntw                                           # exclusive
    count = incw[-1]

    # owner word of each output slot: words own contiguous slot ranges
    # [offw[i], offw[i]+cntw[i]); empty words collapse onto the next
    # offset, so "last word starting at or before j" (scatter-max +
    # cummax) picks the owner.
    arr = jnp.full(width, -1, jnp.int32).at[offw].max(
        jnp.arange(nw, dtype=jnp.int32), mode="drop",
        indices_are_sorted=True)
    blk = jnp.maximum(lax.cummax(arr), 0)                        # (width,)

    off_j = jnp.take(offw, blk)                                  # (width,)
    word = jnp.take(words, blk)
    r = jnp.arange(width, dtype=jnp.int32) - off_j               # in-word rank

    # branchless in-word select of the r-th set bit
    pos = jnp.zeros(width, jnp.int32)
    cur = word
    for half in (16, 8, 4, 2, 1):
        low = lax.population_count(
            cur & ((jnp.uint32(1) << half) - jnp.uint32(1))).astype(jnp.int32)
        go = r >= low
        pos = pos + jnp.where(go, half, 0)
        r = r - jnp.where(go, low, 0)
        cur = jnp.where(go, cur >> half, cur)

    kidx = blk * BLK + pos
    return jnp.minimum(kidx, n - 1), count


def compact_kidx_sort(mask, width: int):
    """compact_kidx via one `lax.sort` — the production path.  Keys
    are the element indices where kept and n (sorts last) where not, so
    the sorted prefix IS the compaction index list."""
    import jax.numpy as jnp
    from jax import lax

    n = mask.shape[0]
    assert width <= n
    key = jnp.where(mask, lax.iota(jnp.int32, n), jnp.int32(n))
    (skey,) = lax.sort((key,), num_keys=1)
    count = jnp.sum(mask, dtype=jnp.int32)
    return jnp.minimum(skey[:width], n - 1), count


def compact_kidx_np(mask: np.ndarray, width: int):
    """NumPy oracle for compact_kidx (exact on the first `count` slots)."""
    idx = np.flatnonzero(mask)
    out = np.zeros(width, dtype=np.int32)
    k = min(len(idx), width)
    out[:k] = idx[:k]
    return out, len(idx)
