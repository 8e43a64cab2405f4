"""Reference-exact mining engine (NumPy, host) — the semantic oracle.

Computes exactly what `metaenumerate` (all samples) + `metaserver` compute,
but as a level-synchronous breadth-first wavefront over dense per-sample
interval tables instead of d lazily-merged DFS byte streams.

Key observation collapsing the reference's client/server split: a sample is
"active" at a union-trie node iff its frequency there is >= fmin along the
whole path — that is precisely the client-side pruning
(EnumerateQuery.cpp:186-190), so the cross-sample union trie can be
generated directly by expanding a dense (nodes x samples) table of BWT
intervals; no per-sample trie serialization or lazy merge is needed.

Per node and sample we carry the forward BWT interval [lo, hi) plus the
start `rlo` of the synchronized REVERSE-index interval (bidirectional /
2BWT search; the reverse interval is [rlo, rlo + (hi-lo))).  This
replaces the reference's four tracked left-extension intervals
(EnumerateQuery.h:44-45, updated per EnumerateQuery.cpp:39-58): a child's
reverse start is rlo + #(occurrences of the node's pattern preceded by a
lexicographically smaller base), a prefix sum over the forward counts,
and the leftChar classification (EnumerateQuery.cpp:77-103) becomes
right-extension counts read from the reverse BWT — `ext interval ==
main interval` is equivalent to `count(P+b) == count(P)` because
interval(P+b) is always a sub-interval of interval(P) (the reference's
stale-keep of empty ext intervals, EnumerateQuery.cpp:44-55, has no
semantic effect: a match requires a nonempty interval, and emptiness is
permanent).  Entropy follows metaserver.cpp:366-389 with
the reference's exact float64 expression shapes: the per-reader term is
((double)(freq+1) * log(freq+1)) / log(2) — multiply THEN divide, C
left-to-right precedence — and the final value
log(sumN)/log(2) - sumNlogN/sumN, so every double rounds identically.
The accumulation order over readers is ascending id; the reference's
libstdc++ unordered_set iteration order differs by ULPs only (gated at
printf("%f") precision by the parity tests; exact gnu-order mode lives in
mining/gnuorder.py).

All output gates follow metaserver.cpp:403-419.  The single-active-reader
fast paths (metaserver.cpp:211-267) produce no stdout when pmin > 1 and
are subsumed by the normal gates when pmin == 1 (traverseOneWithOutput is
dead code — never called).

This implementation is the differential-test oracle for the device wavefront
engine (mining/engine.py); it is itself validated against the compiled
reference binaries (tests/test_parity.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..index.alphabet import EXT_CHARS, EXT_CODES
from ..index.fmindex import FMIndex
from .config import MiningConfig

LOG2 = np.log(2.0)
OCC_CHUNK = 1 << 15

# leftChar aggregate codes
LC_ZERO, LC_N = 0, 1  # '0', 'N'; 2..5 = A,C,G,T


def _lc_char(code: int) -> bytes:
    return b"0N" [code:code + 1] if code < 2 else EXT_CHARS[code - 2:code - 1]


@dataclass
class MinedOutput:
    lines: list[tuple[bytes, float, list[tuple[int, int]]]] = field(default_factory=list)
    total_paths: int = 0
    total_output: int = 0
    total_occs: int = 0
    smallest_entropy: float = 1000.0
    largest_entropy: float = -1000.0
    freq_histogram: np.ndarray | None = None

    def sort_postorder(self) -> None:
        """Lexicographic post-order: children (in A<C<G<T order) before the
        parent — exactly the reference server's print order
        (metaserver.cpp:326-339,468-485).  Equals an ascending sort by
        path + 0xFF (the terminator outranks every base byte)."""
        self.lines.sort(key=lambda t: t[0] + b"\xff")

    def format_lines(self) -> bytes:
        """printf("%s %f", path, entropy) + " %d:%lu" per active reader
        (metaserver.cpp:472-484)."""
        out = []
        for path, entropy, occs in self.lines:
            parts = [path.decode("latin-1"), f"{entropy:f}"]
            parts += [f"{i}:{f}" for i, f in occs]
            out.append(" ".join(parts))
        return ("\n".join(out) + "\n" if out else "").encode()


@dataclass
class _Level:
    # per-node bookkeeping (U nodes at this depth)
    paths: list[bytes]
    lo: np.ndarray   # (U, S) int64, half-open; inactive rows are (0, 0)
    hi: np.ndarray
    rlo: np.ndarray  # (U, S) reverse-interval start; end is rlo + (hi-lo)


def _seed_root(indexes: list[FMIndex]) -> _Level:
    S = len(indexes)
    lo = np.zeros((1, S), dtype=np.int64)
    hi = np.zeros((1, S), dtype=np.int64)
    rlo = np.zeros((1, S), dtype=np.int64)
    for s, idx in enumerate(indexes):
        hi[0, s] = idx.n
    return _Level(paths=[b""], lo=lo, hi=hi, rlo=rlo)


def _occ_psum4(dcum: np.ndarray, pos: np.ndarray):
    """From dense cumulative <=-counts: per-extension-symbol occ and the
    lexicographic prefix sums at `pos` -> (occ4, psum4), each (Q, 4).

    occ(A) = cum2-cum1, occ(C) = cum3-cum2, occ(G) = cum4-cum3,
    occ(T) = pos-cum5; psum(c) = #{codes < c} = cum1, cum2, cum3, cum5
    (codes are in ASCII order: \\0 - A C G N T, index/alphabet.py)."""
    cum = dcum[pos].astype(np.int64)  # (Q, 5) = cum(1..5)
    occ4 = np.stack([cum[:, 1] - cum[:, 0], cum[:, 2] - cum[:, 1],
                     cum[:, 3] - cum[:, 2], pos - cum[:, 4]], axis=1)
    psum4 = np.stack([cum[:, 0], cum[:, 1], cum[:, 2], cum[:, 4]], axis=1)
    return occ4, psum4


def leftchar_np(idx: FMIndex, rlo: np.ndarray, freq: np.ndarray) -> np.ndarray:
    """leftChar codes (EnumerateQuery.cpp:77-103) for one sample's nodes
    from their reverse intervals [rlo, rlo+freq): the base b whose right-
    extension count equals freq (all occurrences extend with b), else 'N'
    if any base extends, else '0'."""
    rocc_lo, _ = _occ_psum4(idx.rdcum, rlo)
    rocc_hi, _ = _occ_psum4(idx.rdcum, rlo + freq)
    rcnt = rocc_hi - rocc_lo  # (Q, 4)
    is_full = (rcnt == freq[:, None]) & (freq[:, None] > 0)
    return np.where(is_full.any(axis=1), is_full.argmax(axis=1) + 2,
                    np.where((rcnt > 0).any(axis=1), LC_N, LC_ZERO))


def _expand(indexes: list[FMIndex], level: _Level, fmin: int):
    """Batched 4-way LF expansion of one frontier level (bidirectional).

    Returns per-child-symbol arrays shaped (4, U, S): clo, chi, crlo,
    cfreq, cactive; plus the CURRENT level's per-(node, sample) leftChar
    codes (U, S) read from the reverse BWT.
    """
    U, S = level.lo.shape
    clo = np.zeros((4, U, S), dtype=np.int64)
    chi = np.zeros((4, U, S), dtype=np.int64)
    crlo = np.zeros((4, U, S), dtype=np.int64)
    lc = np.zeros((U, S), dtype=np.int64)

    parent_active = level.hi > level.lo  # (U, S)
    freq = level.hi - level.lo
    for s, idx in enumerate(indexes):
        occ_lo, psum_lo = _occ_psum4(idx.dcum, level.lo[:, s])
        occ_hi, psum_hi = _occ_psum4(idx.dcum, level.hi[:, s])
        act = parent_active[:, s]
        for ci, c in enumerate(EXT_CODES):
            base = int(idx.C[c])
            clo[ci, :, s] = np.where(act, base + occ_lo[:, ci], 0)
            chi[ci, :, s] = np.where(act, base + occ_hi[:, ci], 0)
            crlo[ci, :, s] = np.where(
                act, level.rlo[:, s] + psum_hi[:, ci] - psum_lo[:, ci], 0)
        lc[:, s] = leftchar_np(idx, level.rlo[:, s], freq[:, s])

    cfreq = np.maximum(chi - clo, 0)
    cactive = parent_active[None, :, :] & (cfreq >= fmin)
    return clo, chi, crlo, cfreq, cactive, lc


def node_entropy(freq: np.ndarray, d: int) -> np.ndarray:
    """Vectorized metaserver.cpp:356-389 with C-exact double rounding.

    freq: (U, S) per-reader occurrence counts (0 for inactive readers —
    an inactive reader contributes (1*log(1))/log(2) == +0.0, an exact
    no-op in IEEE addition, so summing all S ascending columns equals
    summing the active ones ascending).
    """
    f1 = freq.astype(np.float64) + 1.0
    # ((double)(freq+1) * log(freq+1)) / log(2): multiply THEN divide.
    term = (f1 * np.log(f1)) / LOG2
    sumNlogN = np.zeros(freq.shape[0], dtype=np.float64)
    for s in range(freq.shape[1]):  # sequential, ascending-id float order
        sumNlogN = sumNlogN + term[:, s]
    sumN = (d + freq.sum(axis=1)).astype(np.float64)
    return np.log(sumN) / LOG2 - sumNlogN / sumN


def emit_level(
    out: MinedOutput,
    cfg: MiningConfig,
    d: int,
    depth: int,
    paths: list[bytes],
    freq: np.ndarray,        # (U, S) int — 0 for inactive readers
    lc: np.ndarray,          # (U, S) leftChar codes
    single_full: np.ndarray,  # (U,) right-branching-violation flag
    tracker=None,
) -> None:
    """Shared emission stage (metaserver.cpp:356-485): entropy, stats,
    output gates, line assembly.  Used by both the NumPy oracle and the
    per-level device engine (whose device step hands back freq/lc/
    single_full)."""
    active = freq > 0
    nactive = active.sum(axis=1)
    entropy = node_entropy(freq, d)
    present = nactive > 0
    out.total_paths += int(present.sum())
    if present.any():
        # entropy range stats: the reference's single-reader fast path
        # (pmin>1) skips the entropy update entirely
        # (metaserver.cpp:211-226,311-317)
        stat_rows = present & ~((nactive == 1) & (cfg.pmin > 1))
        if stat_rows.any():
            out.smallest_entropy = min(
                out.smallest_entropy, float(entropy[stat_rows].min()))
            out.largest_entropy = max(
                out.largest_entropy, float(entropy[stat_rows].max()))

    # leftChar aggregation (metaserver.cpp:383-387): 'N' unless all
    # active readers agree.  Order-free.
    lc_masked_min = np.where(active, lc, 99).min(axis=1, initial=99)
    lc_masked_max = np.where(active, lc, -1).max(axis=1, initial=-1)
    lc_agg = np.where(lc_masked_min == lc_masked_max, lc_masked_max, LC_N)

    # gates (metaserver.cpp:403-419)
    output = present.copy()
    if depth < cfg.mindepth:
        output[:] = False
    if cfg.pmax != 0:
        output &= nactive <= cfg.pmax
    output &= nactive >= cfg.pmin
    if cfg.emax > 0:
        output &= (entropy >= cfg.emin) & (entropy <= cfg.emax)
    output &= ~single_full          # must be right-branching
    output &= lc_agg < 2            # must be left-branching

    for u in np.flatnonzero(output):
        act = np.flatnonzero(active[u])
        order = act
        if tracker is not None:
            order = np.array(tracker.order_for(paths[u]), dtype=np.int64)
        out.total_output += 1
        out.freq_histogram[act.size - 1] += 1
        occs = [(int(i), int(freq[u, i])) for i in order]
        out.total_occs += len(occs)
        ent = float(entropy[u]) if tracker is None else \
            tracker.entropy_for(paths[u], freq[u], d)
        out.lines.append((paths[u], ent, occs))


def mine_np(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    prefix: bytes = b"",
    reader_order: str = "ascending",
) -> MinedOutput:
    """Mine the full cross-sample union trie (or the subtree under
    `prefix`, the enforcepath equivalent: EnumerateQuery.cpp:240-290).

    reader_order controls the per-line reader ordering (and hence the
    float accumulation order of the entropy sum): 'ascending' id order, or
    'gnu' to replicate the reference's libstdc++ unordered_set iteration
    (mining/gnuorder.py) for byte-exact output.
    """
    cfg.validate()
    d = len(indexes)
    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    tracker = None
    if reader_order == "gnu":
        from .gnuorder import GnuOrderTracker

        tracker = GnuOrderTracker(d, server_prefix_len=max(1, len(prefix)))

    mine_from_level(indexes, cfg, _seed_root(indexes), 0, out,
                    prefix=prefix, tracker=tracker)
    out.sort_postorder()
    return out


def mine_from_level(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    level: _Level,
    depth: int,
    out: MinedOutput,
    prefix: bytes = b"",
    tracker=None,
) -> None:
    """Run the wavefront from an arbitrary frontier `level` at `depth`
    until exhaustion, accumulating into `out` (lines unsorted).  Also the
    tail stage of the hybrid device engine: the accelerator episode hands
    off its narrow deep frontier here (engine_device.mine_device), where
    a thin level costs microseconds instead of a full device step."""
    d = len(indexes)
    prefix_codes = list(prefix)

    while level.lo.shape[0]:
        U, S = level.lo.shape
        clo, chi, crlo, cfreq, cactive, lc = _expand(indexes, level, cfg.fmin)
        at_maxdepth = depth >= cfg.maxdepth
        if not at_maxdepth:
            union_child = cactive.any(axis=2)  # (4, U)
            if depth < len(prefix_codes):
                # enforced path: only descend the prescribed child
                want = EXT_CHARS.index(prefix_codes[depth])
                mask = np.zeros_like(union_child)
                mask[want] = union_child[want]
                union_child = mask
        else:
            union_child = np.zeros((4, U), dtype=bool)
            cactive = np.zeros((4, U, S), dtype=bool)

        # ---- emit current-level nodes (the reference emits post-order;
        # we gather level-order and re-sort at the end) -------------------
        if depth > 0:
            freq = level.hi - level.lo
            # right-branching gate (metaserver.cpp:416-417): exactly one
            # distinct child symbol AND every active reader descends into it
            nactive = (freq > 0).sum(axis=1)
            child_counts = cactive.sum(axis=2)  # (4, U)
            single_idx = union_child.argmax(axis=0)
            single_full = (union_child.sum(axis=0) == 1) & (
                child_counts[single_idx, np.arange(U)] == nactive
            )
            emit_level(out, cfg, d, depth, level.paths, freq, lc,
                       single_full, tracker)

        # ---- build next level -------------------------------------------
        u_idx, ci_idx = np.nonzero(union_child.T)  # row-major: (u, ci) asc
        if tracker is not None:
            tracker.advance(
                depth, level.paths,
                [(int(u), int(c), cactive[c, u])
                 for u, c in zip(u_idx.tolist(), ci_idx.tolist())],
            )
        if u_idx.size == 0:
            break
        paths = level.paths
        next_paths = [paths[u] + EXT_CHARS[c:c + 1]
                      for u, c in zip(u_idx.tolist(), ci_idx.tolist())]
        keep = cactive[ci_idx, u_idx]  # (U', S)
        level = _Level(
            paths=next_paths,
            lo=np.where(keep, clo[ci_idx, u_idx], 0),
            hi=np.where(keep, chi[ci_idx, u_idx], 0),
            rlo=np.where(keep, crlo[ci_idx, u_idx], 0),
        )
        depth += 1
