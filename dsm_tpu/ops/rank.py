"""Batched rank/occ over a small-alphabet BWT — the mining hot primitive.

The reference answers `occ(c, i)` with a Huffman-shaped wavelet tree over
two-level rank bitvectors (HuffWT.h:66-83, BitRank.cpp:191-195) — a
pointer-chase of 2-3 dependent bitvector ranks per query.  Here that
becomes one gather of a flat, fixed-width row per query, which vectorizes
over whole batches of queries.

Host/storage layout (`OccTable`):
  * `blocks`  (nblocks, BLOCK) int8   — BWT codes, PAD-padded tail
  * `occ`     (nblocks+1, SIGMA) int32 — per-symbol counts at block starts

so `occ(c, i) = occ[i // BLOCK, c] + popcount(blocks[i // BLOCK, : i % BLOCK] == c)`:
one row gather + one 128-lane compare-and-sum.  `LF(c, i) = C[c] + occ(c, i)`
(FMIndex.h:84-90).  `occ_prefix_np` is the NumPy oracle used by differential
tests; `occ_batch` is the XLA form.

Device mining layout (`fused_rows` / `occ_cum`): one uint32 row per block
fusing the sampled counts with THERMOMETER BITPLANES of the codes,

    row[0:8]  = cum8[b]  — cum8[j] = #{i < b*BLOCK : code[i] <= j}
    row[8:28] = planes j=1..5, 4 words each — bit k of word w is
                (code[b*BLOCK + 32*w + k] <= j), LSB-first

so ONE gather + 5 (AND + popcount over 4 words) yields the cumulative
<=-counts cum(1..5, i), from which both the per-symbol occ of every
extension base (A=cum2-cum1, C=cum3-cum2, G=cum4-cum3, T=i-cum5) and the
lexicographic prefix sums needed for bidirectional (2BWT) interval
synchronization fall out (the symbol codes are in ASCII order —
index/alphabet.py — which is what makes <=-counts sufficient).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.alphabet import PAD, SIGMA

BLOCK = 128  # symbols per fused row
LOG2_BLOCK = 7


@dataclass
class OccTable:
    """Sampled occurrence counts + padded code blocks for one BWT."""

    n: int
    blocks: np.ndarray  # (nblocks, BLOCK) int8
    occ: np.ndarray     # (nblocks + 1, SIGMA) int32
    counts: np.ndarray  # (SIGMA,) int64 — total per-symbol counts
    C: np.ndarray       # (SIGMA + 1,) int64 — chars with smaller code

    @classmethod
    def build(cls, bwt: np.ndarray) -> "OccTable":
        n = int(bwt.shape[0])
        nblocks = -(-n // BLOCK) if n else 0
        padded = np.full(nblocks * BLOCK, PAD, dtype=np.int8)
        padded[:n] = bwt
        blocks = padded.reshape(nblocks, BLOCK)
        onehot = blocks[:, :, None] == np.arange(SIGMA, dtype=np.int8)
        per_block = onehot.sum(axis=1, dtype=np.int64)
        occ = np.zeros((nblocks + 1, SIGMA), dtype=np.int64)
        np.cumsum(per_block, axis=0, out=occ[1:])
        counts = occ[-1].copy()
        if n:
            counts[PAD] -= nblocks * BLOCK - n  # padding is not text
            occ[-1, PAD] = counts[PAD]
        C = np.zeros(SIGMA + 1, dtype=np.int64)
        np.cumsum(counts, out=C[1:])
        if int(C[-1]) != n:
            raise AssertionError("occ table count mismatch")
        return cls(n=n, blocks=blocks, occ=occ.astype(np.int32), counts=counts, C=C)


def occ_prefix_np(table: OccTable, syms: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """NumPy oracle: count of syms[j] in L[: pos[j]] for each query j.

    pos is a prefix *length* in [0, n]; this equals the reference's
    inclusive `rank(c, i)` at i = pos-1, with rank(c, -1) == 0
    (BitRank.cpp:191-195 wraps i+1 to 0 for i == (ulong)-1).
    """
    syms = np.atleast_1d(np.asarray(syms))
    pos = np.atleast_1d(np.asarray(pos, dtype=np.int64))
    b, r = pos >> LOG2_BLOCK, pos & (BLOCK - 1)
    base = table.occ[b, syms].astype(np.int64)
    rows = table.blocks[b]  # (Q, BLOCK)
    lane = np.arange(BLOCK, dtype=np.int64)
    inblock = ((rows == syms[:, None]) & (lane[None, :] < r[:, None])).sum(axis=1)
    return base + inblock


ROWW = 32          # fused uint32 row width: 8 cum + 5 planes x 4 words (+pad)
_NPLANES = 5       # thermometer levels j = 1..5 (j=6 is the identity: pos)


def fused_rows(table: OccTable, c4=None) -> np.ndarray:
    """Build the fused cum8+bitplane mining rows for one BWT.

    -> (nblocks + 1, ROWW) uint32.  The final row carries the total cum8
    so positions with i % BLOCK == 0 at i == nblocks*BLOCK resolve without
    touching planes.  PAD codes (tail padding) satisfy no plane test.

    `c4` ((4,) ints: C[c] for c in A,C,G,T) BAKES the per-sample LF base
    constants into the stored cum columns: with K = (0, C4[A],
    C4[A]+C4[C], C4[A]+C4[C]+C4[G], -C4[T]) added to cum(1..5), the
    per-symbol occ differences come out as C4[c] + occ(c, i) — the child
    interval bound itself — so the mining engines never gather or add C4
    at runtime.  The lexicographic prefix sums (psum4) and the leftChar
    counts only ever consume DIFFERENCES of cum values at two positions
    of the same sample, where K cancels exactly; occ_cum returns the
    shifted values via a bitcast (negative K wraps mod 2^32).
    """
    nblocks = table.blocks.shape[0]
    rows = np.zeros((nblocks + 1, ROWW), dtype=np.uint32)
    codes = table.blocks  # (nblocks, BLOCK) int8, PAD-padded
    # per-block per-symbol counts -> cumulative <=-counts at block starts
    onehot = codes[:, :, None] == np.arange(SIGMA, dtype=np.int8)
    per_block = onehot.sum(axis=1, dtype=np.int64)  # (nblocks, SIGMA)
    if nblocks:
        # padding is PAD (code 7); keep cum8[:, 7] text-only like occ
        per_block[-1, PAD] -= int(nblocks * BLOCK - table.n)
    cum = np.zeros((nblocks + 1, SIGMA), dtype=np.int64)
    np.cumsum(np.cumsum(per_block, axis=1), axis=0, out=cum[1:])
    if c4 is not None:
        a, c, g, t = (int(v) for v in c4)
        K = np.array([0, 0, a, a + c, a + c + g, -t, 0, 0], dtype=np.int64)
        cum = (cum + K[None, :]) & 0xFFFFFFFF
    rows[:, :SIGMA] = cum.astype(np.uint32)
    # thermometer planes
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    for j in range(1, _NPLANES + 1):
        bits = (codes <= j).reshape(nblocks, 4, 32)
        words = (bits.astype(np.uint64) * weights).sum(axis=2)
        rows[:nblocks, SIGMA + (j - 1) * 4: SIGMA + j * 4] = words.astype(np.uint32)
    return rows


def _plane_counts(planes, rem):
    """Masked popcounts of the 20 plane words at in-block offsets `rem`.

    planes: (20, Q) uint32 (plane-major, 4 words per plane); rem: (Q,)
    int32 in [0, BLOCK).  Returns (5, Q) uint32 counts of codes <= j,
    j = 1..5, among the first `rem` symbols of each block."""
    import jax.numpy as jnp
    from jax import lax

    w = rem >> 5
    bit = (rem & 31).astype(jnp.uint32)
    colw20 = jnp.tile(jnp.arange(4, dtype=jnp.int32), _NPLANES)
    full = jnp.where(colw20[:, None] < w[None, :],
                     jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    part = jnp.where(colw20[:, None] == w[None, :],
                     (jnp.uint32(1) << bit[None, :]) - jnp.uint32(1),
                     jnp.uint32(0))
    pc = lax.population_count(planes & (full | part))    # (20, Q)
    return pc.reshape(_NPLANES, 4, -1).sum(axis=1, dtype=jnp.uint32)


def occ_cum(rows, blk, rem):
    """Batched cumulative <=-counts from fused rows (jit-safe).

    rows: (R, ROWW) uint32 fused table (possibly several BWTs stacked —
    callers add per-BWT row offsets into `blk`); blk (...,) int32 row
    index; rem (...,) int32 in [0, BLOCK).  Returns (..., 5) int32 =
    cum(j, pos) for j = 1..5 where pos = blk*BLOCK + rem.

    Integer arithmetic throughout, as in occ_cumT: the base columns are
    bitcast (baked-C4 cums wrap uint32, and the wrap cancels in every
    difference the callers take) and the plane words are summed as
    masked popcounts."""
    import jax.numpy as jnp
    from jax import lax

    shape = blk.shape
    g = jnp.take(rows, blk.reshape(-1), axis=0).T        # (ROWW, Q)
    cnt5 = _plane_counts(g[8:28], rem.reshape(-1))
    base5 = lax.bitcast_convert_type(g[1:6], jnp.int32)
    v = base5 + lax.bitcast_convert_type(cnt5, jnp.int32)
    return v.T.reshape(shape + (5,))


def occ_cumT(rowsT, blk, rem):
    """Batched cumulative <=-counts from a TRANSPOSED fused table.

    rowsT: (ROWW, R) uint32 — `fused_rows(...).T`, the mining episode's
    layout; blk/rem: (Q,) int32.  Returns (5, Q) int32 cum(1..5).

    The column gather `take(rowsT, blk, axis=1)` lands the row's words
    on the major axis, so base extraction (rows 1:6), the plane masks
    and the per-plane popcount sums are all major-axis operations on
    the gathered block.  Not yet compared on the GPU with the row-major
    form (occ_cum)."""
    import jax.numpy as jnp
    from jax import lax

    g = jnp.take(rowsT, blk, axis=1)                     # (32, Q)
    cnt5 = _plane_counts(g[8:28], rem)                   # (5, Q)
    base5 = lax.bitcast_convert_type(g[1:6], jnp.int32)
    return base5 + lax.bitcast_convert_type(cnt5, jnp.int32)


def occ_cum8T(rowsT, blk, rem, pos):
    """Transposed fused rank: (8, Q) int32 with rows
    [C4A+occA, C4C+occC, C4G+occG, pos-c5(+C4T), c1, c2, c3, c5]
    for baked-C4 tables (fused_rows c4=) — rows 0:4 ARE the per-symbol
    child bounds, rows 4:8 the lexicographic prefix sums.  Built on
    occ_cumT (transposed-table column gather); the occ/psum assembly is
    a major-axis concatenation."""
    import jax.numpy as jnp

    c = occ_cumT(rowsT, blk, rem)                      # (5, Q)
    return jnp.concatenate([
        (c[1] - c[0])[None], (c[2] - c[1])[None], (c[3] - c[2])[None],
        (pos - c[4])[None],
        c[0][None], c[1][None], c[2][None], c[4][None]], axis=0)


def occ_cum_np(table: OccTable, pos: np.ndarray) -> np.ndarray:
    """NumPy oracle for occ_cum: (..., 5) int64 cumulative <=-counts of
    codes 1..5 in L[: pos]."""
    pos = np.asarray(pos, dtype=np.int64)
    flat = table.blocks.reshape(-1)
    out = np.empty(pos.shape + (5,), dtype=np.int64)
    for j in range(1, 6):
        le = np.concatenate([[0], np.cumsum(flat <= j)])
        out[..., j - 1] = le[pos]
    return out


def occ_batch(blocks, occ, syms, pos):
    """XLA batched occ: jnp arrays in, (Q,) int32 counts out.

    blocks: (nblocks, BLOCK) int8; occ: (nblocks+1, SIGMA) int32;
    syms: (Q,) int8/int32; pos: (Q,) int32 prefix lengths in [0, n].
    Safe for any pos in range because occ has nblocks+1 rows and the final
    partial block is PAD-padded (PAD never equals a query symbol).
    """
    import jax.numpy as jnp

    pos = pos.astype(jnp.int32)
    syms_i = syms.astype(jnp.int32)
    b = pos >> LOG2_BLOCK
    r = pos & (BLOCK - 1)
    base = occ[b, syms_i]
    rows = jnp.take(blocks, b, axis=0, indices_are_sorted=False, unique_indices=False)
    lane = jnp.arange(BLOCK, dtype=jnp.int32)
    match = (rows == syms.astype(jnp.int8)[..., None]) & (lane < r[..., None])
    return base + jnp.sum(match, axis=-1, dtype=jnp.int32)
