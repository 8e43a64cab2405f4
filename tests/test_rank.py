"""The fused-row rank primitives against the NumPy oracle.

occ_cum (row-major table), occ_cumT and occ_cum8T (transposed table)
must return exactly occ_cum_np's cumulative <=-counts — shifted by the
baked-in LF constants when the table carries them (fused_rows c4=) —
on random BWTs, at every block edge and at random positions.
`check_rank` is shared with the GPU test (tests/test_gpu.py).
"""

import numpy as np
import pytest

from dsm_tpu.ops.rank import (BLOCK, LOG2_BLOCK, OccTable, fused_rows,
                              occ_cum, occ_cum8T, occ_cum_np, occ_cumT)

RANK_FNS = ("occ_cum", "occ_cumT", "occ_cum8T")


def _positions(n: int, rng) -> np.ndarray:
    edges = np.arange(0, n + 1, BLOCK)
    edge = np.concatenate([edges, edges - 1, edges + 1, [0, n, n - 1]])
    pos = np.concatenate([edge, rng.integers(0, n + 1, size=500)])
    return np.unique(pos[(pos >= 0) & (pos <= n)])


def check_rank(fn: str, n: int, seed: int, baked: bool) -> None:
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    bwt = rng.integers(0, 7, size=n).astype(np.int8)   # codes 0..6, no PAD
    table = OccTable.build(bwt)
    c4 = [int(v) for v in rng.integers(0, 1 << 30, size=4)] if baked \
        else None
    rows = fused_rows(table, c4=c4)
    pos = _positions(n, rng)
    want = occ_cum_np(table, pos)                      # (Q, 5) int64
    if baked:
        a, c, g, t = c4
        want = want + np.array([0, a, a + c, a + c + g, -t])
    want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)   # int32 wrap
    blk = jnp.asarray((pos >> LOG2_BLOCK).astype(np.int32))
    rem = jnp.asarray((pos & (BLOCK - 1)).astype(np.int32))
    if fn == "occ_cum":
        got = np.asarray(occ_cum(jnp.asarray(rows), blk, rem))
    elif fn == "occ_cumT":
        got = np.asarray(occ_cumT(jnp.asarray(rows.T), blk, rem)).T
    else:
        got = np.asarray(occ_cum8T(jnp.asarray(rows.T), blk, rem,
                                   jnp.asarray(pos.astype(np.int32)))).T
        w = want.astype(np.int64)
        want = np.stack([w[:, 1] - w[:, 0], w[:, 2] - w[:, 1],
                         w[:, 3] - w[:, 2], pos - w[:, 4],
                         w[:, 0], w[:, 1], w[:, 2], w[:, 4]], axis=1)
        want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("baked", [False, True], ids=["plain", "baked_c4"])
@pytest.mark.parametrize("n", [1, 127, 128, 1000, 4096])
@pytest.mark.parametrize("fn", RANK_FNS)
def test_rank_matches_oracle(fn, n, baked):
    check_rank(fn, n, seed=n, baked=baked)


def test_occ_cum_batched_shape():
    """occ_cum keeps any leading batch shape: (CAP, S) positions in,
    (CAP, S, 5) counts out, as expand_core and leftchar_codes call it."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    table = OccTable.build(rng.integers(0, 7, size=900).astype(np.int8))
    rows = jnp.asarray(fused_rows(table))
    pos = rng.integers(0, 901, size=(6, 3))
    got = occ_cum(rows, jnp.asarray(pos >> LOG2_BLOCK, dtype=jnp.int32),
                  jnp.asarray(pos & (BLOCK - 1), dtype=jnp.int32))
    assert got.shape == (6, 3, 5)
    np.testing.assert_array_equal(np.asarray(got), occ_cum_np(table, pos))
