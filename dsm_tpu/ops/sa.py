"""Suffix-array construction by parallel prefix doubling.

The reference builds its BWT through RLCSA, whose core sorter is a
Larsson-Sadakane prefix-doubling suffix sort (reference:
incbwt/misc/utils.cpp:297-384).  Prefix doubling is also the natural
device algorithm: each round is one global sort (`jax.lax.sort`) plus
elementwise rank reassignment — no data-dependent control flow, O(log n)
rounds of O(n log n) sorting.

Two implementations with identical results:
  * `suffix_array_np`  — NumPy (host, used for tests and small builds)
  * `suffix_array_jax` — jax.lax.sort based (device; int64 keys, so the
    combined rank-pair key requires n < 2**31)

The input is a code sequence (any non-negative integer dtype).  The suffix
array is over the *linear* string; multi-text collections are handled by the
caller concatenating each text followed by its terminator code 0, which
makes position-index tie-breaking irrelevant for pattern counting (no
mining pattern contains the terminator).
"""

from __future__ import annotations

import numpy as np


def suffix_array_np(codes: np.ndarray) -> np.ndarray:
    """Suffix array of `codes` via prefix doubling (host/NumPy)."""
    n = int(codes.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)

    rank = np.ascontiguousarray(codes, dtype=np.int64)
    k = 1
    while True:
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        kf, ks = rank[order], second[order]
        neq = np.empty(n, dtype=np.int64)
        neq[0] = 0
        neq[1:] = (kf[1:] != kf[:-1]) | (ks[1:] != ks[:-1])
        new_at_order = np.cumsum(neq)
        if new_at_order[-1] == n - 1:
            return order.astype(np.int64)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_at_order
        k *= 2


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT[i] = codes[SA[i]-1] (cyclic).  With every text terminated by
    code 0 the wrap-around lands on a terminator, reproducing the
    counting semantics of the reference's pseudo-BWT (FMIndex.cpp:473-480):
    LF on terminators is never taken by the mining path, and per-symbol
    interval counts for terminator-free patterns are exact."""
    return np.ascontiguousarray(codes[(sa - 1) % len(codes)])


def suffix_array_jax(codes) -> "jax.Array":  # noqa: F821
    """Prefix-doubling suffix array with jax.lax.sort (device-side).

    Mirrors `suffix_array_np`; rounds run under lax.while_loop with an
    early-exit predicate on all-ranks-unique.

    The input is right-padded with DISTINCT negative codes to the next
    power of two so every text length up to that power shares one
    compiled program (which then persists in the compilation cache).
    Padding codes [-pad, ..., -1] (increasing toward the end):
      * any window comparison between two REAL suffixes that runs past
        the text is decided at the first padding touch, where exactly
        one side is sub-real (both sides padding at the same offset
        would need equal suffix starts) — the same outcome as
        `suffix_array_np`'s -1 out-of-range convention, so real-suffix
        order is unchanged;
      * padding suffixes have distinct first codes, so the
        prefix-doubling ranks separate immediately (a UNIFORM pad value
        would leave one rank class and spin the early-exit loop
        forever), and they all sort before every real suffix — the real
        suffix array is exactly the trailing slice.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    n_real = int(codes.shape[0])
    if n_real <= 1:
        return jnp.zeros(n_real, dtype=jnp.int32)
    if n_real >= (1 << 31):
        raise ValueError("suffix_array_jax requires n < 2**31")
    n = 1 << (n_real - 1).bit_length()

    codes = jnp.asarray(codes).astype(jnp.int32)
    if n > n_real:
        pad = n - n_real
        codes = jnp.concatenate(
            [codes, jnp.arange(-pad, 0, dtype=jnp.int32)])
    iota = lax.iota(jnp.int32, n)

    def round_(state):
        rank, k, _ = state
        second = jnp.where(iota + k < n, jnp.roll(rank, -k), -1)
        # Two-key lexicographic sort avoids packing rank pairs into int64
        # (which would need jax_enable_x64); num_keys=2 sorts by
        # (rank, second) and carries the suffix index along.
        k1, k2, order = lax.sort((rank, second, iota), num_keys=2)
        neq = jnp.concatenate(
            [
                jnp.zeros(1, jnp.int32),
                ((k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])).astype(jnp.int32),
            ]
        )
        new_at_order = jnp.cumsum(neq)
        done = new_at_order[-1] == n - 1
        rank = jnp.zeros(n, jnp.int32).at[order].set(new_at_order)
        return rank, k * 2, done

    def cond(state):
        return jnp.logical_not(state[2])

    rank0 = codes
    rank, _, _ = lax.while_loop(cond, round_, (rank0, jnp.int32(1), jnp.bool_(False)))
    # rank is now the inverse permutation of the suffix array
    _, sa = lax.sort((rank, iota), num_keys=1)
    # padding suffixes (all-smaller) fill the leading slots: slice off
    return sa[n - n_real:]
