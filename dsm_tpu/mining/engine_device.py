"""Resident-device mining: the whole wavefront loop inside one XLA program.

The per-level engine (mining/engine.py) pays one host round-trip per trie
level, and tries are hundreds of levels deep.  Here the entire reference
pipeline (EnumerateQuery DFS + metaserver merge/gates,
metaserver.cpp:269-486) becomes ONE jitted `lax.while_loop` episode:

  * the frontier is a SPARSE pair list, not a dense (node, sample)
    matrix: union tries of real metagenomes keep only ~1.3 of d samples
    active per node (deep nodes are sample-specific), so a dense row
    would waste most of its rank gathers on empty intervals.  Each live
    pair is one row of a packed (PROW, 8) int32 matrix holding (lo, hi,
    rlo, sample, node, table offset) — the bidirectional intervals plus
    its sample id, its node's row in the current level and its
    sample's row offset in the stacked tables;
  * each level is ONE full-width vectorized pass at a BUCKET size
    chosen per level by `lax.switch` from the live pair/node counts —
    powers of two plus 3*2^k half-steps (bucket_ladder), so the
    dozens-of-levels mid-trie plateau runs with ~1.1x lane slack
    instead of ~1.5x.  No per-level host round-trips, nothing chunked
    or serialized.  On one device, per-node statistics are segment
    broadcasts over the node-contiguous pair list (_level_single), and
    child compaction is a single multi-operand sort keyed on
    (node, symbol, pair offset) whose kept stream also yields child
    ids, history entries and nb boundaries from (parent, symbol)
    changes.  Under sharding the per-node rows must be node-indexed on
    every shard for the psum merge, so that path keeps the prefix-sum
    boundary gather and the exists-lattice numbering (_level_sharded).
    The pair list is kept sorted by node id with each node's pairs
    contiguous — the vectorized form of the reference's d-stream lazy
    trie merge (metaserver.cpp:269-486), where "streams meet at a
    node" becomes "pairs of a node are adjacent";
  * capacity is FIXED per run (next_pow2 of the total text length,
    clamped) so the episode compiles exactly once; pair capacity gets
    2x headroom and a (rare) overflow still grows via FLAG_GROW;
  * the pair list is double-buffered [2, PROW, 8]: levels read half p
    and write half 1-p at offset 0 and committing flips the parity
    scalar (no lax.cond: a redo only freezes the scalar counters — all
    writes land at offset 0 of the write half / beyond the committed
    offsets, and the redone level overwrites them);
  * NO path strings are materialized on device AND the packed
    parent-pointer history is never bulk-pulled: it stays
    device-resident, and the few paths the host needs (gated outputs,
    tail handoff, checkpoints) are decoded by an on-device ancestor
    walk (_decode_rows) that pulls only (rows, depth) bytes;
  * the left-branching gate (metaserver.cpp:418-419) is deferred to
    drain time, where leftchar_codes_pairs runs on device for just the
    candidate pairs — traversal never touches the reverse-index ranks;
  * the entropy window is gated in float32 with a safety margin; the
    host re-checks drained candidates in float64 with the reference's
    exact expression shapes (engine_np.node_entropy), so emitted lines
    are bit-identical to the oracle while the device never touches f64;
  * gated rows leave through a SMALL staging block appended every
    level (a lax.cond carrying the out buffer would copy it per level;
    the buffer is 330 KB, not O(capacity)); levels gated past EMIT_W
    rows drain in node-aligned chunks tracked by `eskip`;
  * the episode exits only to report: completion, output-buffer pressure
    (host drains, resumes), history pressure (host drains outputs, pulls
    the finished levels into PathHistory, resets — the level is redone
    with no emission on the overflow branch, so no duplicates), frontier
    shrink past TAIL_WIDTH/TAIL_MIN_DEPTH (host wavefront finishes the
    deep thin tail), or capacity overflow (only past the CAP_MAX clamp).

Host work per episode is O(drained outputs), not O(trie bytes).
Semantics are those of engine_np.mine_np; byte-exact gnu-order runs
reconstruct the reference's libstdc++ set-iteration orders post hoc for
the sparse emitted paths (mining/gnulazy.py) — the episode itself is
order-independent.

Entropy min/max *statistics* (stderr diagnostics in the reference,
metaserver.cpp:390-394,805-813) are tracked in float32 here; the output
lines themselves are exact.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from ..index.alphabet import EXT_CHARS
from ..index.fmindex import FMIndex
from ..ops.compact import compact_kidx_sort
from ..ops.rank import BLOCK, LOG2_BLOCK, occ_cum, occ_cum8T
from .config import MiningConfig
from .engine import (MAX_SAMPLES, DeviceIndexes, _occ_psum4,
                     leftchar_codes_pairsT)
from .engine_np import LOG2, MinedOutput, node_entropy

LB_MIN = 13           # smallest level bucket: 2^13 = 8192
DEV_MIN_CAP = 1 << LB_MIN
CAP_MAX = 1 << 22     # node-capacity clamp; beyond this FLAG_GROW kicks in
# FLAG_GROW ceiling: the level buffers and big-bucket temps (occ
# intermediates, scan rows, sort operands) all scale with the bucket, so
# growth stops here and the run raises with the partitioning guidance
# instead of an out-of-memory compile.  Kept from the first sizing; not
# yet measured against the GPU's memory.
CAP_GROW_MAX = 1 << 23
PAIR_HEADROOM = 2     # PROW = PAIR_HEADROOM * NCAP (avg active samples per
#                       node is ~1.3 on real metagenomes; overflow grows)
GROWTH = 4            # capacity growth factor on (rare) overflow
OUT_RESERVE = 1 << 15  # drained-output buffer target size (pair rows)
EMIT_W = 1 << 13       # per-level emit staging width (chunked past this)
LVL_CAP = 1 << 13      # per-segment level-offset slots
ENT_MARGIN = 1e-2      # f32 entropy gate slack; host re-gates in f64
DECODE_K = 4096        # rows per on-device path-decode dispatch
(FLAG_RUN, FLAG_DONE, FLAG_DRAIN, FLAG_GROW, FLAG_HISTFULL,
 FLAG_TAIL) = range(6)
PFX_MAX = 16           # enforced-prefix symbols carried as traced state

# packed pair-row columns ((PROW, 8) int32); PC_SOFF carries the pair's
# per-sample occ-table row offset so expansion needs NO per-pair meta
# gather (C4 is baked into the tables themselves, fused_rows c4=)
PC_LO, PC_HI, PC_RLO, PC_SID, PC_NID, PC_SOFF = range(6)
# packed output-row columns ((ocap, 8) int32)
OC_FREQ, OC_RLO, OC_SID, OC_ROW, OC_DEPTH = range(5)

# Hand the frontier to the host numpy wavefront once it is this narrow
# and past this depth: a device level costs about the same for 2 live
# rows as for the smallest bucket, and deep tries (long repeats) have
# thousands of near-empty levels — the reference's followOneBranch fast
# lane (EnumerateQuery.cpp:105-149) solves the same problem recursively.
# Not yet tuned on the GPU.
TAIL_WIDTH = 768
TAIL_MIN_DEPTH = 12


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def _auto_cap(dev: DeviceIndexes, floor: int) -> int:
    """Fixed node capacity.  The hard bound is next_pow2(sum n_s) (a
    union level cannot hold more nodes than distinct substrings), but
    measured metagenome tries peak well under n/4, and oversizing costs
    every level real milliseconds (the level buffers are carried through
    the bucket switch, whose boundary copies scale with capacity).  So
    start at a quarter of the bound and let the (compile-cached)
    FLAG_GROW exit quadruple it in the rare case a level overflows —
    one GROWTH step lands exactly on the old conservative sizing."""
    want = min(max(_next_pow2(int(dev.ns.sum()) + 1) // 4, DEV_MIN_CAP),
               CAP_MAX)
    return max(DEV_MIN_CAP, _next_pow2(floor), want)


def _hist_cap(dev: DeviceIndexes) -> int:
    """Device history sizing: one int32 per union-trie node.  Tries are
    typically a small multiple of the text length; 8x covers everything
    we have measured, and overflow degrades to a (pulled) FLAG_HISTFULL
    segment, never to an error.  The clamp bounds the buffer at 1 GiB of
    device memory, which keeps history pulls rare; the bound is not yet
    measured on the GPU (DSM_HIST_CAP overrides)."""
    env = os.environ.get("DSM_HIST_CAP")
    if env:
        return int(env)
    want = 8 * _next_pow2(int(dev.ns.sum()) + 1)
    return max(1 << 20, min(want, 1 << 28))


class PathHistory:
    """Host-side decoder for pulled parent-pointer history segments.

    Only FLAG_HISTFULL exits pull history off the device; in the common
    case this holds nothing and decoding happens on device.  Level d's
    entries (one int32 per node: parent_row*4 + sym, in node-id order)
    map rows at depth d to (parent row at d-1, symbol); segments
    accumulate keyed by absolute depth.  base_paths seeds rows at
    base_depth (checkpoint resume)."""

    def __init__(self, base_depth: int = 0,
                 base_paths: list[bytes] | None = None) -> None:
        self.base_depth = base_depth
        self.base = base_paths if base_paths is not None else [b""]
        self.levels: dict[int, np.ndarray] = {}

    def add_segment(self, d0: int, packed: np.ndarray,
                    lens: np.ndarray) -> None:
        """Levels d0+1 .. d0+len(lens) from one pulled device segment."""
        off = 0
        for k, ln in enumerate(np.asarray(lens, dtype=np.int64).tolist()):
            self.levels[d0 + k + 1] = packed[off:off + ln]
            off += ln

    def decode(self, depth: int, rows: np.ndarray) -> list[bytes]:
        """Paths of frontier `rows` at `depth` (vectorized walk down)."""
        rows = np.asarray(rows, dtype=np.int64)
        m = rows.shape[0]
        k = depth - self.base_depth
        syms = np.zeros((m, k), dtype=np.int64)
        r = rows.copy()
        for d in range(depth, self.base_depth, -1):
            e = self.levels[d][r]
            syms[:, d - self.base_depth - 1] = e & 3
            r = e >> 2
        ext = np.frombuffer(EXT_CHARS, dtype=np.uint8)
        return [self.base[int(r[i])] + ext[syms[i]].tobytes()
                for i in range(m)]


@dataclass
class _Scalars:
    """Runtime mining knobs, traced (no recompile across configs)."""

    fmin: object
    pmin: object
    pmax: object
    emin: object
    emax: object
    use_egate: object
    mindepth: object
    maxdepth: object
    tail_width: object
    out_reserve: object
    pcs: object = None      # (PFX_MAX,) int32 enforced-prefix codes
    plen: object = None     # int32 enforced-prefix length

    @classmethod
    def build(cls, cfg: MiningConfig, tail_width: int = TAIL_WIDTH,
              out_reserve: int = OUT_RESERVE,
              prefix_codes: tuple = ()):
        import jax.numpy as jnp

        i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
        maxd = min(cfg.maxdepth, 2**31 - 1)
        if len(prefix_codes) > PFX_MAX:
            raise ValueError(
                f"enforced prefix longer than {PFX_MAX} symbols")
        pcs = np.zeros(PFX_MAX, dtype=np.int32)
        pcs[:len(prefix_codes)] = prefix_codes
        return cls(
            fmin=i32(cfg.fmin), pmin=i32(cfg.pmin), pmax=i32(cfg.pmax),
            emin=jnp.asarray(cfg.emin, jnp.float32),
            emax=jnp.asarray(cfg.emax, jnp.float32),
            use_egate=jnp.asarray(cfg.emax > 0, bool),
            mindepth=i32(cfg.mindepth), maxdepth=i32(maxd),
            tail_width=i32(tail_width), out_reserve=i32(out_reserve),
            pcs=jnp.asarray(pcs), plen=i32(len(prefix_codes)),
        )

    def flat(self):
        return (self.fmin, self.pmin, self.pmax, self.emin, self.emax,
                self.use_egate, self.mindepth, self.maxdepth,
                self.tail_width, self.out_reserve, self.pcs, self.plen)


def _seed_episode(dev: DeviceIndexes, cap: int, hist_cap: int | None = None):
    """Fresh episode state.

    pr [2, PROW, 8] is the double-buffered packed sparse pair list
    (columns PC_*: lo/hi/rlo intervals + sample id + node id), kept
    GLOBALLY SORTED by node id with each node's pairs contiguous (see
    _level_at_bucket); `parity` selects the live half.  nb [2, NBROW]
    maps node id -> first-pair index (one extra sentinel entry =
    npairs).  hist/lvl_off are the device-resident parent-pointer
    history of the current segment; out [(ocap, 8)] collects gated
    output-candidate pairs (columns OC_*) until a drain exit."""
    import jax.numpy as jnp

    S = dev.S
    if hist_cap is None:
        hist_cap = _hist_cap(dev)
    ncap = cap
    prow = PAIR_HEADROOM * cap
    nbrow = prow + 2
    # emission is chunked at EMIT_W rows per level, so the out buffer no
    # longer scales with capacity (it used to be OUT_RESERVE + prow)
    ocap = OUT_RESERVE + EMIT_W + 1
    ns32 = jnp.asarray(dev.ns, jnp.int32)
    sid0 = jnp.arange(S, dtype=jnp.int32)
    pr = jnp.zeros((2, prow, 8), jnp.int32)
    pr = pr.at[0, :S, PC_HI].set(ns32)
    pr = pr.at[0, :S, PC_SID].set(sid0)
    pr = pr.at[0, :S, PC_SOFF].set(jnp.asarray(dev.soff, jnp.int32))
    return dict(
        pr=pr,
        nb=jnp.zeros((2, nbrow), jnp.int32).at[0, 1].set(S),
        parity=jnp.asarray(0, jnp.int32),
        npairs=jnp.asarray(S, jnp.int32),
        nnodes=jnp.asarray(1, jnp.int32),
        depth=jnp.asarray(0, jnp.int32),
        hist=jnp.zeros(hist_cap + ncap, jnp.int32),
        hist_len=jnp.asarray(0, jnp.int32),
        lvl_off=jnp.zeros(LVL_CAP, jnp.int32),
        nlev=jnp.asarray(0, jnp.int32),
        out=jnp.zeros((ocap, 8), jnp.int32),
        ocount=jnp.asarray(0, jnp.int32),
        eskip=jnp.asarray(0, jnp.int32),
        boost=jnp.asarray(0, jnp.int32),
        total_paths=jnp.asarray(0, jnp.int32),
        ent_min=jnp.asarray(np.inf, jnp.float32),
        ent_max=jnp.asarray(-np.inf, jnp.float32),
        flag=jnp.asarray(FLAG_RUN, jnp.int32),
    )


_NLN_FP = 17  # fixed-point fractional bits for the (f+1)log2(f+1) sums


def _nln_windows(term):
    """Split v = trunc(term * 2^_NLN_FP) (a conceptual 54-bit integer; term =
    (f+1)log2(f+1) in float32, f < 2^31) into three int32 streams:
    v's 16-bit windows w0 = v[0:16], w1 = v[16:32] and the top w2 =
    v >> 32.  Prefix sums of each stream wrap int32, but per-node
    boundary DIFFERENCES are exact: a node has <= S pairs, so the true
    low-window sums are < S * 2^16 and the top-window sum is
    < S * 2^(54-32) = S * 2^22 — all < 2^31 for S <= MAX_SAMPLES = 512
    (mine_device enforces the bound) — which is all the entropy gate
    reads; no int64 anywhere (JAX x64 stays off, so an int64 request
    here would silently truncate and overflow).
    Quantization is <= 2^-_NLN_FP per term: far inside ENT_MARGIN."""
    import jax.numpy as jnp

    mant, expo = jnp.frexp(term)                 # term = mant * 2^expo
    m = (mant * np.float32(1 << 24)).astype(jnp.int32)   # [2^23, 2^24)
    s = (expo - (24 - _NLN_FP)).astype(jnp.int32)        # v = m * 2^s
    nz = term > 0

    def window(k):
        t = s - 16 * k
        pos = ((m & 0xFFFF) << jnp.clip(t, 0, 31)) & 0xFFFF
        neg = (m >> jnp.clip(-t, 0, 31)) & 0xFFFF
        w = jnp.where(t >= 16, 0, jnp.where(t >= 0, pos, neg))
        return jnp.where(nz, w, 0)

    w2 = jnp.where(nz, m >> jnp.clip(32 - s, 0, 31), 0)
    return jnp.stack([window(0), window(1), w2], axis=-1)   # (..., 3)


def _nln_value(d3):
    """Reassemble float32 sums from (..., 3) int32 window differences."""
    import jax.numpy as jnp

    f = d3.astype(jnp.float32)
    return ((f[..., 0] + f[..., 1] * np.float32(1 << 16)
             + f[..., 2] * np.float32(2.0 ** 32))
            * np.float32(2.0 ** -_NLN_FP))


def _level_sharded(B: int, dev_frowsT, s_total: int,
                   sc: _Scalars, hist_cap, axis_name: str, state):
    """One trie level of the SHARDED episode at static bucket width B —
    the shard_map body of parallel/engine_episode.py.  The pair list,
    nb boundaries and occ tables hold only this shard's samples; the
    per-node boundary statistics are psum'd over the samples axis — the
    device form of the reference's cross-sample trie-stream merge
    (metaserver.cpp:159-189,325-339).  Everything derived from the
    psum'd values (child numbering, gates, history, flags) is computed
    identically on every shard; pair compaction and output emission
    stay local.

    Shares _level_single's structure: ranks go through the
    transposed-table column gather (ops/rank.occ_cumT) and every child
    table lives c-major, so the (4, B) -> (4B,) flattens are free.  What stays different from _level_single, by necessity:

      * per-node statistics must sit at NODE-INDEXED rows so the psum
        aligns them across shards (a shard may hold no pairs at all for
        some node), so they come from boundary gathers of the (8, B+1)
        transposed prefix sums at this shard's nb array — not from the
        per-pair segment broadcasts;
      * child ids come from the GLOBAL exists lattice (cumsum over the
        psum'd per-symbol counts), and the next pair list is gathered
        from a c-major child table by compaction indices — the hv-key
        payload sort cannot know about pairs other shards hold.

    Commit/redo contract identical to _level_single."""
    import jax.numpy as jnp
    from jax import lax

    _, prow, _ = state["pr"].shape
    ncap = (state["hist"].shape[0] - hist_cap)
    nbrow = state["nb"].shape[1]
    ocap = state["out"].shape[0]
    depth = state["depth"]
    P = state["npairs"]
    U = state["nnodes"]
    par = state["parity"]
    wpar = 1 - par
    # entropy uses the GLOBAL sample count d (metaserver.cpp:356-389),
    # which under sharding exceeds this shard's local slice
    S_total = s_total

    sym_mask = jnp.ones(4, dtype=bool)
    enforced = sc.pcs[jnp.minimum(depth, sc.pcs.shape[0] - 1)]
    onehot = jnp.arange(4, dtype=jnp.int32) == enforced
    sym_mask = jnp.where(depth < sc.plen, onehot, sym_mask)
    sym_mask = sym_mask & (depth < sc.maxdepth)

    iota_b = jnp.arange(B, dtype=jnp.int32)

    # ---- expand: transposed ranks -> c-major child tables -------------
    prs = lax.dynamic_slice(state["pr"], (par, 0, 0), (1, B, 8))[0]
    lo, hi, rlo = prs[:, PC_LO], prs[:, PC_HI], prs[:, PC_RLO]
    sid, nid = prs[:, PC_SID], prs[:, PC_NID]
    soff_p = prs[:, PC_SOFF]
    validp = iota_b < P

    olo = occ_cum8T(dev_frowsT, (lo >> LOG2_BLOCK) + soff_p,
                    lo & (BLOCK - 1), lo)               # (8, B)
    ohi = occ_cum8T(dev_frowsT, (hi >> LOG2_BLOCK) + soff_p,
                    hi & (BLOCK - 1), hi)
    pa = validp & (hi > lo)
    clo_m = jnp.where(pa[None, :], olo[0:4], 0)         # (4, B)
    chi_m = jnp.where(pa[None, :], ohi[0:4], 0)
    crlo_m = jnp.where(pa[None, :],
                       rlo[None, :] + (ohi[4:8] - olo[4:8]), 0)
    cact = pa[None, :] & (chi_m - clo_m >= sc.fmin)     # (4, B)
    keepc = cact & sym_mask[:, None]

    # ---- stats: transposed prefix sums + nb boundary gathers ----------
    freq = jnp.where(pa, hi - lo, 0)
    f1 = (freq + 1).astype(jnp.float32)
    nlnw = _nln_windows_w(jnp.where(pa, f1 * jnp.log2(f1), 0.0), 16, 3)
    statT = jnp.stack([freq] + nlnw
                      + [cact[c].astype(jnp.int32) for c in range(4)],
                      axis=0)                           # (8, B)
    validn = iota_b < U
    cumT = jnp.concatenate(
        [jnp.zeros((8, 1), jnp.int32), jnp.cumsum(statT, axis=1)],
        axis=1)                                         # (8, B+1)
    nbs = lax.dynamic_slice(state["nb"], (par, 0), (1, B + 1))[0]
    gbT = jnp.take(cumT, jnp.clip(nbs, 0, B), axis=1)   # (8, B+1)
    d8T = jnp.where(validn[None, :], gbT[:, 1:] - gbT[:, :-1], 0)
    cnt_localT = d8T[4:8]                               # (4, B)
    nact_local = jnp.where(validn, nbs[1:] - nbs[:B], 0)
    # the trie merge: global per-node statistics over the mesh
    d8T = lax.psum(d8T, axis_name)
    nact = lax.psum(nact_local, axis_name)
    sumf = d8T[0]
    sumnln = _nln_value_w([d8T[1], d8T[2], d8T[3]], 16)
    cntT = d8T[4:8]                                     # (4, B) global
    exists4 = (cntT > 0) & sym_mask[:, None] & validn[None, :]

    exn = exists4.sum(axis=1, dtype=jnp.int32)          # (4,)
    # local region sizes: this shard's surviving pairs per child region
    rgs = jnp.where(exists4, cnt_localT, 0).sum(axis=1, dtype=jnp.int32)
    child_total = exn.sum()
    pair_count = rgs.sum()

    # ---- gates (metaserver.cpp:403-417; left-branching at drain) ------
    numchildren = exists4.sum(axis=0)
    single_full = (numchildren == 1) & (
        jnp.where(exists4, cntT, 0).sum(axis=0) == nact)
    sumN = (S_total + sumf).astype(jnp.float32)
    ent32 = jnp.log(sumN) / np.float32(LOG2) - sumnln / sumN
    present = validn & (nact > 0) & (depth >= 1)
    egate = jnp.where(
        sc.use_egate,
        (ent32 >= sc.emin - ENT_MARGIN) & (ent32 <= sc.emax + ENT_MARGIN),
        True)
    nd_out = (present & (depth >= sc.mindepth)
              & (nact >= sc.pmin)
              & ((sc.pmax == 0) | (nact <= sc.pmax))
              & egate & ~single_full)

    stat_rows = present & ~((nact == 1) & (sc.pmin > 1))
    ent_min = jnp.minimum(state["ent_min"],
                          jnp.where(stat_rows, ent32, np.inf).min())
    ent_max = jnp.maximum(state["ent_max"],
                          jnp.where(stat_rows, ent32, -np.inf).max())
    total_paths = state["total_paths"] + present.sum(dtype=jnp.int32)

    # ---- children: global exists-lattice numbering + local gather -----
    wn = min(B, ncap)
    wp = min(B, prow)
    woff = jnp.minimum(state["hist_len"], jnp.int32(hist_cap))
    iota4b = jnp.arange(4 * B, dtype=jnp.int32)
    K = keepc.reshape(4 * B)                            # c-major keep
    E = exists4.reshape(4 * B)                          # flat i = c*B + u
    cid_flat = jnp.where(E, jnp.cumsum(E.astype(jnp.int32)) - 1, -1)
    cid_mat = cid_flat.reshape(4, B).T                  # (B, 4): node, sym
    hv = (iota4b % B) * 4 + iota4b // B                 # parent_row*4+sym
    pcnt = jnp.where(exists4, cnt_localT, 0).reshape(4 * B)
    nbv = jnp.cumsum(pcnt) - pcnt                       # child's first pair
    kidx_n, _ = compact_kidx_sort(E, wn)
    rows_n = jnp.stack([hv, nbv], axis=1)               # (4B, 2)
    g_n = jnp.take(rows_n, kidx_n, axis=0)              # (wn, 2)
    hist = lax.dynamic_update_slice(state["hist"], g_n[:, 0], (woff,))
    nb_next = lax.dynamic_update_slice(state["nb"], g_n[:, 1][None],
                                       (wpar, 0))
    cid_nd = jnp.take(cid_mat, jnp.minimum(nid, B - 1), axis=0)
    childrows = jnp.stack(
        [clo_m.reshape(4 * B), chi_m.reshape(4 * B),
         crlo_m.reshape(4 * B),
         jnp.broadcast_to(sid[None, :], (4, B)).reshape(4 * B),
         cid_nd.T.reshape(4 * B),
         jnp.broadcast_to(soff_p[None, :], (4, B)).reshape(4 * B),
         jnp.zeros(4 * B, jnp.int32),
         jnp.zeros(4 * B, jnp.int32)], axis=1)          # (4B, 8)
    kidx_p, _ = compact_kidx_sort(K, wp)
    newpr = jnp.take(childrows, kidx_p, axis=0)         # (wp, 8)
    pr = lax.dynamic_update_slice(state["pr"], newpr[None],
                                  (wpar, 0, 0))
    nb_next = lax.dynamic_update_slice(
        nb_next, pair_count[None, None],
        (wpar, jnp.minimum(child_total, jnp.int32(nbrow - 1))))

    # ---- emit: stage gated pairs, append unconditionally --------------
    # Chunks cut at NODE boundaries using GLOBAL per-node pair counts so
    # every shard selects the same node set; a node has <= S <=
    # MAX_SAMPLES < EMIT_W pairs globally, so each chunk advances >= 1
    # node (see _level_single's emit block for the staging rationale).
    W = min(EMIT_W, B)
    estart = state["eskip"]
    gp = jnp.where(nd_out, nact, 0)                     # global pairs/node
    cum_gp = jnp.cumsum(gp)                             # inclusive (B,)
    tg = cum_gp[B - 1]                                  # total gated pairs
    take_node = nd_out & (cum_gp > estart) & (cum_gp <= estart + W)
    cut = jnp.max(jnp.where(take_node, cum_gp, estart))

    def build_stage(_):
        sel = validp & (jnp.take(take_node.astype(jnp.int32),
                                 jnp.minimum(nid, B - 1)) > 0)
        orows = jnp.concatenate(
            [(hi - lo)[:, None], rlo[:, None], sid[:, None], nid[:, None],
             jnp.full((B, 1), depth, jnp.int32),
             jnp.zeros((B, 3), jnp.int32)], axis=1)     # (B, 8)
        kidx_o, wrote = compact_kidx_sort(sel, W)
        return jnp.take(orows, kidx_o, axis=0), wrote   # (W, 8), local

    stage, wrote = lax.cond(
        tg > estart,
        build_stage,
        lambda _: (jnp.zeros((W, 8), jnp.int32), jnp.int32(0)), 0)
    out = lax.dynamic_update_slice(
        state["out"], stage,
        (jnp.minimum(state["ocount"], jnp.int32(ocap - W)), 0))
    oc = state["ocount"] + wrote

    # ---- flags + commit (identical on every shard: per-shard
    # predicates are any-reduced over the mesh) -------------------------
    grow = (child_total > ncap) | (pair_count > prow)
    refit = ~grow & ((pair_count > wp) | (child_total > wn))
    drain = oc > sc.out_reserve
    burst = cut < tg
    grow = lax.psum(grow.astype(jnp.int32), axis_name) > 0
    refit = lax.psum(refit.astype(jnp.int32), axis_name) > 0
    drain = lax.psum(drain.astype(jnp.int32), axis_name) > 0
    # burst/cut derive from psum'd nact: already uniform across shards
    histfull = (state["hist_len"] + child_total > hist_cap) \
        | (state["nlev"] + 1 >= LVL_CAP)
    burst = burst & ~(grow | histfull | refit)
    commit = ~(grow | histfull | refit | burst)
    boost = jnp.where(refit & ~histfull, state["boost"] + 1,
                      jnp.where(commit, 0, state["boost"]))
    flag = jnp.where(
        grow, FLAG_GROW,
        jnp.where(
            histfull, FLAG_HISTFULL,
            jnp.where(
                refit, FLAG_RUN,
                jnp.where(
                    burst, FLAG_DRAIN,
                    jnp.where(
                        child_total == 0, FLAG_DONE,
                        jnp.where((child_total <= sc.tail_width)
                                  & (depth + 1 >= TAIL_MIN_DEPTH),
                                  FLAG_TAIL,
                                  jnp.where(drain, FLAG_DRAIN,
                                            FLAG_RUN))))))).astype(jnp.int32)

    def keep_if(new, old):
        return jnp.where(commit, new, old)

    return dict(
        pr=pr, nb=nb_next,
        parity=keep_if(wpar, par),
        npairs=keep_if(pair_count, P),
        nnodes=keep_if(child_total, U),
        depth=keep_if(depth + 1, depth),
        hist=hist,
        hist_len=keep_if(state["hist_len"] + child_total,
                         state["hist_len"]),
        lvl_off=jnp.asarray(state["lvl_off"]).at[state["nlev"]].set(
            state["hist_len"]),
        nlev=keep_if(state["nlev"] + 1, state["nlev"]),
        out=out,
        ocount=jnp.where(commit | burst, oc, state["ocount"]),
        eskip=jnp.where(commit, 0, jnp.where(burst, cut, estart)),
        boost=boost,
        total_paths=keep_if(total_paths, state["total_paths"]),
        ent_min=keep_if(ent_min, state["ent_min"]),
        ent_max=keep_if(ent_max, state["ent_max"]),
        flag=flag,
    )


def _use_poff_key(B: int, P2: int) -> bool:
    """True when the children-sort key can carry (nid*4+c)*P2 + poff in
    uint32 without colliding with the drop sentinel; extreme
    (bucket x sample-count) combinations key on hv alone with a stable
    sort instead (tests monkeypatch this to pin the fallback)."""
    return 4 * B * P2 < 1 << 32


def _nln_windows_w(term, wbits: int, nwin: int):
    """Generalized fixed-point windows of v = trunc(term * 2^_NLN_FP):
    nwin windows of wbits bits each (window k = bits [k*wbits,
    (k+1)*wbits) of v).  Per-term window values < 2^wbits, so a cumsum
    over B terms stays < B * 2^wbits — choose wbits = 31 - ceil_log2(B)
    and the cumsums NEVER wrap int32, which is what lets the per-pair
    segment broadcasts (cummax/cummin in _level_single) rely on
    monotonicity.  v < 2^53 (term < 2^36, _NLN_FP = 17), so
    nwin = ceil(53 / wbits) windows cover every bit."""
    import jax.numpy as jnp

    mant, expo = jnp.frexp(term)                 # term = mant * 2^expo
    m = (mant * np.float32(1 << 24)).astype(jnp.int32)   # [2^23, 2^24)
    s = (expo - (24 - _NLN_FP)).astype(jnp.int32)        # v = m * 2^s
    nz = term > 0
    mask = jnp.int32((1 << wbits) - 1)

    def window(k):
        t = s - wbits * k                        # m bit0 position in win
        tpos = jnp.clip(t, 0, 31)
        tneg = jnp.clip(-t, 0, 31)
        w = ((m >> tneg) & (mask >> tpos)) << tpos
        return jnp.where(nz, w, 0)

    return [window(k) for k in range(nwin)]      # list of term-shaped


def _nln_value_w(winsums, wbits: int):
    """float32 sums from per-window int32 segment sums."""
    import jax.numpy as jnp

    acc = jnp.zeros_like(winsums[0], dtype=jnp.float32)
    for k, wsum in enumerate(winsums):
        acc = acc + wsum.astype(jnp.float32) * np.float32(
            2.0 ** (k * wbits - _NLN_FP))
    return acc


def _level_single(B: int, dev_frows, dev_rrows, s_total: int,
                  sc: _Scalars, hist_cap, state):
    """One single-device trie level at static bucket width B, with the
    semantics of `_level_sharded` on one shard (differentially tested
    against engine_np):

      * expansion consumes the occ gather through `occ_cum8T`, whose
        (8, B) c-major output feeds the c-major child tables with row
        slices only;
      * per-node statistics are SEGMENT BROADCASTS, not a sort: one
        (NC, B) minor-axis cumsum + a forward cummax (value at node
        start) + a reverse cummin (value at node end) put every node's
        sums on every one of its pair lanes — replacing the 9-operand
        stats sort AND the per-pair node-flag gather (a 1-D
        B-from-B gather) the emit stage would otherwise need.
        Monotonicity holds because every scanned column is a cumsum of
        nonnegative int32 that provably never wraps: freq sums are
        bounded by the total indexed symbols (< 2^31 by the
        MAX_TABLE_ROWS guard) and the entropy windows use
        bucket-dependent widths (_nln_windows_w);
      * the children sort keys on hv = (nid*4 + sym) * P2 + poff
        (uint32) instead of the c-major lane index: the key itself
        carries the (parent, symbol) stream the boundary logic needs,
        dropping a `nid` payload operand, and orders children
        NODE-major (the trie DFS order) — pairs of a child stay
        contiguous because poff < P2 tie-breaks by pair order.

    The sharded path keeps `_level_sharded`: its per-node rows must be
    node-indexed on every shard for the psum merge, which is exactly
    what the boundary-gather forms give.
    """
    import jax.numpy as jnp
    from jax import lax

    _, prow, _ = state["pr"].shape
    ncap = state["hist"].shape[0] - hist_cap
    nbrow = state["nb"].shape[1]
    ocap = state["out"].shape[0]
    depth = state["depth"]
    P = state["npairs"]
    par = state["parity"]
    wpar = 1 - par
    S_total = s_total

    # enforced prefix as TRACED state (sc.pcs/sc.plen): one compiled
    # episode serves every prefix partition — per-prefix runs (gnu
    # parity, big-trie partitioning) stopped costing a full ladder
    # recompile each
    sym_mask = jnp.ones(4, dtype=bool)
    enforced = sc.pcs[jnp.minimum(depth, sc.pcs.shape[0] - 1)]
    onehot = jnp.arange(4, dtype=jnp.int32) == enforced
    sym_mask = jnp.where(depth < sc.plen, onehot, sym_mask)
    sym_mask = sym_mask & (depth < sc.maxdepth)

    iota_b = jnp.arange(B, dtype=jnp.int32)

    # ---- expand: one fused transposed rank for both interval ends ----
    prs = lax.dynamic_slice(state["pr"], (par, 0, 0), (1, B, 8))[0]
    lo, hi, rlo = prs[:, PC_LO], prs[:, PC_HI], prs[:, PC_RLO]
    sid, nid = prs[:, PC_SID], prs[:, PC_NID]
    soff_p = prs[:, PC_SOFF]
    validp = iota_b < P

    # two B-wide rank calls, not one concatenated 2B call, so neither
    # result needs a minor-dim split
    olo = occ_cum8T(dev_frows, (lo >> LOG2_BLOCK) + soff_p,
                    lo & (BLOCK - 1), lo)               # (8, B)
    ohi = occ_cum8T(dev_frows, (hi >> LOG2_BLOCK) + soff_p,
                    hi & (BLOCK - 1), hi)
    clo_m = olo[0:4]                                    # (4, B) c-major
    chi_m = ohi[0:4]
    crlo_m = rlo[None, :] + (ohi[4:8] - olo[4:8])
    pa = validp & (hi > lo)
    cfreq = chi_m - clo_m
    cact = pa[None, :] & (cfreq >= sc.fmin)             # (4, B)
    keepc = cact & sym_mask[:, None]

    # ---- per-pair node statistics via segment broadcasts -------------
    wbits = 31 - max(B - 1, 1).bit_length()
    nwin = -(-53 // wbits)
    freq = jnp.where(pa, hi - lo, 0)
    f1 = (freq + 1).astype(jnp.float32)
    nlnw = _nln_windows_w(jnp.where(pa, f1 * jnp.log2(f1), 0.0),
                          wbits, nwin)
    # the active-reader count uses pa, not validp: pairs normally all
    # have freq >= 1, but the halt side channel (_apply_halt) empties
    # pruned pairs in place and they must not count as readers
    M = jnp.stack([freq] + nlnw
                  + [cact[c].astype(jnp.int32) for c in range(4)]
                  + [pa.astype(jnp.int32)], axis=0)      # (6+nwin, B)
    NC = 6 + nwin
    A = jnp.cumsum(M, axis=1)
    nid_x = jnp.where(validp, nid, jnp.int32(B) + iota_b)
    prev_nid = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                nid_x[:-1]])
    next_nid = jnp.concatenate([nid_x[1:],
                                jnp.full((1,), -2, jnp.int32)])
    firstp = nid_x != prev_nid
    lstp = nid_x != next_nid
    A_shift = jnp.concatenate(
        [jnp.zeros((NC, 1), jnp.int32), A[:, :-1]], axis=1)
    A_pre = lax.cummax(jnp.where(firstp[None, :], A_shift, 0), axis=1)
    A_end = lax.cummin(
        jnp.where(lstp[None, :], A, jnp.int32(2**31 - 1)),
        axis=1, reverse=True)
    d = A_end - A_pre                                   # (NC, B) per-pair
    sumf = d[0]
    sumnln = _nln_value_w([d[1 + k] for k in range(nwin)], wbits)
    cnt4 = d[1 + nwin:5 + nwin]                         # (4, B)
    nact = d[5 + nwin]

    exists4 = (cnt4 > 0) & sym_mask[:, None] & validp[None, :]
    numchildren = exists4.sum(axis=0)
    single_full = (numchildren == 1) & (
        jnp.where(exists4, cnt4, 0).sum(axis=0) == nact)
    sumN = (S_total + sumf).astype(jnp.float32)
    ent32 = jnp.log(sumN) / np.float32(LOG2) - sumnln / sumN
    present = validp & (nact > 0) & (depth >= 1)
    egate = jnp.where(
        sc.use_egate,
        (ent32 >= sc.emin - ENT_MARGIN) & (ent32 <= sc.emax + ENT_MARGIN),
        True)
    nd_out = (present & (depth >= sc.mindepth)
              & (nact >= sc.pmin)
              & ((sc.pmax == 0) | (nact <= sc.pmax))
              & egate & ~single_full)                   # per PAIR

    stat_first = firstp & present & ~((nact == 1) & (sc.pmin > 1))
    ent_min = jnp.minimum(state["ent_min"],
                          jnp.where(stat_first, ent32, np.inf).min())
    ent_max = jnp.maximum(state["ent_max"],
                          jnp.where(stat_first, ent32, -np.inf).max())
    total_paths = state["total_paths"] + (
        present & firstp).sum(dtype=jnp.int32)

    exn = (exists4 & firstp[None, :]).sum(axis=1, dtype=jnp.int32)
    rgs = keepc.sum(axis=1, dtype=jnp.int32)
    child_total = exn.sum()
    pair_count = rgs.sum()

    # ---- children: hv-keyed compaction sort --------------------------
    wn = min(B, ncap)
    wp = min(B, prow)
    woff = jnp.minimum(state["hist_len"], jnp.int32(hist_cap))
    iota_wp = jnp.arange(wp, dtype=jnp.int32)
    P2 = _next_pow2(max(s_total, 2))
    if _use_poff_key(B, P2):
        # unique key (nid*4 + c)*P2 + poff: key values < 4*B*P2 <=
        # 2^32 - P2, so uint32 arithmetic is exact and the 0xFFFFFFFF
        # drop sentinel cannot collide with a kept key
        log2P2 = P2.bit_length() - 1
        first_pos = lax.cummax(jnp.where(firstp, iota_b, 0))
        poff = iota_b - first_pos                       # < S <= P2
        hv_b = (nid.astype(jnp.uint32) * jnp.uint32(4 * P2)
                + poff.astype(jnp.uint32))              # + c*P2 per row
        stable = False
    else:
        # extreme (bucket x sample-count): key on hv alone (< 4B, no
        # overflow possible) and rely on sort stability — equal-hv
        # lanes sit in c-major order, which IS ascending pair order
        log2P2 = 0
        hv_b = nid.astype(jnp.uint32) * jnp.uint32(4)
        stable = True
    hv_lane = (hv_b[None, :]
               + (jnp.arange(4, dtype=jnp.uint32)
                  * jnp.uint32(max(P2, 1) if not stable else 1))[:, None])
    key_u = jnp.where(keepc, hv_lane,
                      jnp.uint32(0xFFFFFFFF)).reshape(4 * B)
    sidsoff = soff_p * jnp.int32(MAX_SAMPLES) + sid
    skey, s_clo, s_chi, s_crlo, s_ss = lax.sort(
        (key_u, clo_m.reshape(4 * B), chi_m.reshape(4 * B),
         crlo_m.reshape(4 * B),
         jnp.broadcast_to(sidsoff[None, :], (4, B)).reshape(4 * B)),
        num_keys=1, is_stable=stable)
    validk = iota_wp < pair_count
    hv_kept = jnp.where(
        validk, (skey[:wp] >> log2P2).astype(jnp.int32), -1)
    prev_hv = jnp.concatenate([jnp.full((1,), -2, jnp.int32),
                               hv_kept[:-1]])
    bdry = validk & (hv_kept != prev_hv)
    cid_pair = jnp.cumsum(bdry.astype(jnp.int32)) - 1
    newpr = jnp.stack(
        [s_clo[:wp], s_chi[:wp], s_crlo[:wp],
         s_ss[:wp] % jnp.int32(MAX_SAMPLES), cid_pair,
         s_ss[:wp] // jnp.int32(MAX_SAMPLES),
         jnp.zeros(wp, jnp.int32), jnp.zeros(wp, jnp.int32)],
        axis=1)                                         # (wp, 8)
    pr = lax.dynamic_update_slice(state["pr"], newpr[None],
                                  (wpar, 0, 0))
    key_b = jnp.where(bdry, iota_wp, jnp.int32(wp))
    sk2, s_hv = lax.sort((key_b, hv_kept), num_keys=1)
    hist = lax.dynamic_update_slice(state["hist"], s_hv[:wn], (woff,))
    nb_next = lax.dynamic_update_slice(
        state["nb"],
        jnp.minimum(sk2[:wn], pair_count)[None], (wpar, 0))
    nb_next = lax.dynamic_update_slice(
        nb_next, pair_count[None, None],
        (wpar, jnp.minimum(child_total, jnp.int32(nbrow - 1))))

    # ---- emit: per-pair chunk selection (no node->pair gather) -------
    W = min(EMIT_W, B)
    estart = state["eskip"]
    cg = jnp.cumsum(nd_out.astype(jnp.int32))           # gated pairs
    cg_end = lax.cummin(
        jnp.where(lstp, cg, jnp.int32(2**31 - 1)), reverse=True)
    tg = cg[B - 1]
    take_pair = nd_out & (cg_end > estart) & (cg_end <= estart + W)
    cut = jnp.max(jnp.where(take_pair, cg_end, estart))

    def build_stage(_):
        orows = jnp.concatenate(
            [(hi - lo)[:, None], rlo[:, None], sid[:, None], nid[:, None],
             jnp.full((B, 1), depth, jnp.int32),
             jnp.zeros((B, 3), jnp.int32)], axis=1)     # (B, 8)
        kidx_o, wrote = compact_kidx_sort(take_pair, W)
        return jnp.take(orows, kidx_o, axis=0), wrote

    stage, wrote = lax.cond(
        tg > estart,
        build_stage,
        lambda _: (jnp.zeros((W, 8), jnp.int32), jnp.int32(0)), 0)
    out = lax.dynamic_update_slice(
        state["out"], stage,
        (jnp.minimum(state["ocount"], jnp.int32(ocap - W)), 0))
    oc = state["ocount"] + wrote

    # ---- flags + commit (same contract as _level_at_bucket) ----------
    grow = (child_total > ncap) | (pair_count > prow)
    refit = ~grow & ((pair_count > wp) | (child_total > wn))
    drain = oc > sc.out_reserve
    burst = cut < tg
    histfull = (state["hist_len"] + child_total > hist_cap) \
        | (state["nlev"] + 1 >= LVL_CAP)
    burst = burst & ~(grow | histfull | refit)
    commit = ~(grow | histfull | refit | burst)
    boost = jnp.where(refit & ~histfull, state["boost"] + 1,
                      jnp.where(commit, 0, state["boost"]))
    flag = jnp.where(
        grow, FLAG_GROW,
        jnp.where(
            histfull, FLAG_HISTFULL,
            jnp.where(
                refit, FLAG_RUN,
                jnp.where(
                    burst, FLAG_DRAIN,
                    jnp.where(
                        child_total == 0, FLAG_DONE,
                        jnp.where((child_total <= sc.tail_width)
                                  & (depth + 1 >= TAIL_MIN_DEPTH),
                                  FLAG_TAIL,
                                  jnp.where(drain, FLAG_DRAIN,
                                            FLAG_RUN))))))).astype(jnp.int32)

    def keep_if(new, old):
        return jnp.where(commit, new, old)

    return dict(
        pr=pr, nb=nb_next,
        parity=keep_if(wpar, par),
        npairs=keep_if(pair_count, P),
        nnodes=keep_if(child_total, state["nnodes"]),
        depth=keep_if(depth + 1, depth),
        hist=hist,
        hist_len=keep_if(state["hist_len"] + child_total,
                         state["hist_len"]),
        lvl_off=jnp.asarray(state["lvl_off"]).at[state["nlev"]].set(
            state["hist_len"]),
        nlev=keep_if(state["nlev"] + 1, state["nlev"]),
        out=out,
        ocount=jnp.where(commit | burst, oc, state["ocount"]),
        eskip=jnp.where(commit, 0, jnp.where(burst, cut, estart)),
        boost=boost,
        total_paths=keep_if(total_paths, state["total_paths"]),
        ent_min=keep_if(ent_min, state["ent_min"]),
        ent_max=keep_if(ent_max, state["ent_max"]),
        flag=flag,
    )


def _ceil_log2(x):
    """Traced ceil(log2(max(x, 1))) for int32 x <= 2^24 (exact in f32)."""
    import jax.numpy as jnp

    mant, expo = jnp.frexp(jnp.maximum(x, 1).astype(jnp.float32))
    return (expo - (mant == np.float32(0.5)).astype(jnp.int32))


HALF_STEP_MIN = 1 << 18   # add 3*2^k half-step buckets from this size up


def bucket_ladder(prow: int) -> list[int]:
    """Static level-bucket sizes: powers of two from DEV_MIN_CAP to
    prow, with 3*2^(k-1) half-steps interleaved above HALF_STEP_MIN.
    The mid-trie plateau sits just above a power of two for dozens of
    levels; the half-steps cut its ~1.5x
    processed-lane slack to ~1.1x on exactly the levels that dominate
    wall time, while small levels keep the short pow2-only ladder
    (compile cost grows with ladder length)."""
    out = []
    b = DEV_MIN_CAP
    while b <= prow:
        out.append(b)
        half = b + b // 2
        if half >= HALF_STEP_MIN and half <= prow:
            out.append(half)
        b *= 2
    return out


@functools.cache
def _jitted_episode(cap: int, hist_cap: int, S: int):
    import jax
    import jax.numpy as jnp
    from jax import lax

    ladder = bucket_ladder(PAIR_HEADROOM * cap)

    def run(frows, rrows, state, *flat_scalars):
        sc = _Scalars(*flat_scalars)
        lad = jnp.asarray(ladder, jnp.int32)

        def cond(st):
            return st["flag"] == FLAG_RUN

        def body(st):
            need = jnp.maximum(st["npairs"], st["nnodes"] + 1)
            k = jnp.clip(jnp.sum(lad < need) + st["boost"], 0,
                         len(ladder) - 1)
            branches = [
                functools.partial(_level_single, b, frows, rrows, S,
                                  sc, hist_cap)
                for b in ladder
            ]
            return lax.switch(k, branches, st)

        return jax.lax.while_loop(cond, body, state)

    return jax.jit(run, donate_argnums=(2,))


@functools.cache
def _jitted_decode(dcols: int):
    """On-device ancestor walk: rows at per-row relative levels `jvec`
    (1-based within the current history segment) walk down to the segment
    base, scattering one symbol per level into a (DECODE_K, dcols) int8
    matrix.  Pulls are O(rows * depth) bytes instead of the whole
    history."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def run(hist, lvl_off, rows, jvec):
        def body(_, carry):
            rows, jcur, syms = carry
            take = jcur >= 1
            off = jnp.where(take, lvl_off[jnp.maximum(jcur - 1, 0)], 0)
            e = jnp.where(take, hist[off + rows], 0)
            col = jnp.where(take, jcur - 1, dcols)  # dcols = OOB -> dropped
            syms = syms.at[jnp.arange(rows.shape[0]), col].set(
                (e & 3).astype(jnp.int8), mode="drop")
            rows = jnp.where(take, e >> 2, rows)
            return rows, jcur - 1, syms

        syms0 = jnp.zeros((rows.shape[0], dcols), jnp.int8)
        rows, _, syms = lax.fori_loop(0, dcols, body, (rows, jvec, syms0))
        return rows, syms

    return jax.jit(run)


def _decode_rows(state, ph: PathHistory, seg_depth0: int,
                 rows: np.ndarray, depths: np.ndarray) -> list[bytes]:
    """Paths for node `rows` at absolute `depths` (vectorized): the
    device walks each row to the current segment's base; PathHistory
    covers any earlier (pulled) segments and the checkpoint base."""
    import jax
    import jax.numpy as jnp

    rows = np.asarray(rows, dtype=np.int32)
    depths = np.asarray(depths, dtype=np.int32)
    m = rows.shape[0]
    if m == 0:
        return []
    jvec_all = depths - seg_depth0
    maxj = int(jvec_all.max(initial=0))
    if maxj == 0:
        return ph.decode(seg_depth0, rows)
    dcols = -(-maxj // 128) * 128
    fn = _jitted_decode(dcols)
    ext = np.frombuffer(EXT_CHARS, dtype=np.uint8)
    paths: list[bytes] = []
    for g0 in range(0, m, DECODE_K):
        grp = slice(g0, min(g0 + DECODE_K, m))
        k = grp.stop - grp.start
        r = np.zeros(DECODE_K, dtype=np.int32)
        j = np.zeros(DECODE_K, dtype=np.int32)
        r[:k] = rows[grp]
        j[:k] = jvec_all[grp]
        base_rows, syms = jax.device_get(fn(
            state["hist"], state["lvl_off"],
            jnp.asarray(r), jnp.asarray(j)))
        bases = ph.decode(seg_depth0, base_rows[:k])
        for i in range(k):
            paths.append(bases[i] + ext[syms[i, :jvec_all[g0 + i]]
                                        .astype(np.int64)].tobytes())
    return paths


def _pull_segment(ph: PathHistory, seg_depth0: int, state) -> None:
    """FLAG_HISTFULL fallback: pull the device's finished-level history
    into the host decoder and reset the device-side segment.  Any outputs
    referencing the segment must be drained (device-decoded) BEFORE this
    resets the offsets."""
    import jax
    import jax.numpy as jnp

    n = int(state["hist_len"])
    k = int(state["nlev"])
    if k:
        packed, offs = jax.device_get(
            (state["hist"][:n], state["lvl_off"][:k]))
        lens = np.diff(np.append(offs, n))
        ph.add_segment(seg_depth0, packed, lens)
    state["hist_len"] = jnp.asarray(0, jnp.int32)
    state["nlev"] = jnp.asarray(0, jnp.int32)


@functools.cache
def _jitted_lc_pairs():
    import jax

    def run(rrowsT, soff, sid, rlo, freq):
        return leftchar_codes_pairsT(rrowsT, soff[sid], rlo, freq)

    return jax.jit(run)


def _drain(out: MinedOutput, cfg: MiningConfig, d: int, state,
           ph: PathHistory, seg_depth0: int, dev: DeviceIndexes,
           tracker=None) -> None:
    """Pull output-candidate pairs, apply the deferred left-branching
    gate (leftchar_codes_pairs on device for just these pairs), re-gate
    the entropy window in exact f64 per node, decode node paths on
    device, and append formatted lines.  `tracker` (mining/gnulazy.py)
    switches the emitted reader order and entropy accumulation to the
    reference's libstdc++ set-iteration order; gates stay ascending-f64
    exactly like the oracle (engine_np.emit_level)."""
    import jax
    import jax.numpy as jnp

    n = int(state["ocount"])
    if n == 0:
        return
    npad = min(_next_pow2(n), state["out"].shape[0])
    lc_dev = _jitted_lc_pairs()(dev.rrowsT, dev.soff,
                                state["out"][:npad, OC_SID],
                                state["out"][:npad, OC_RLO],
                                state["out"][:npad, OC_FREQ])
    orows, lc = jax.device_get((state["out"][:n], lc_dev[:n]))
    freq = orows[:, OC_FREQ]
    sid = orows[:, OC_SID]
    rows = orows[:, OC_ROW]
    depths = orows[:, OC_DEPTH]
    state["ocount"] = jnp.asarray(0, jnp.int32)

    # group pairs by (depth, node row) preserving first-seen order
    key = depths.astype(np.int64) << 32 | rows.astype(np.int64)
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)                      # first-seen node order
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    g = rank[inv]                                  # pair -> group index
    m = uniq.size
    fmat = np.zeros((m, d), dtype=np.int64)
    fmat[g, sid] = freq
    lcmat = np.full((m, d), -1, dtype=np.int64)
    lcmat[g, sid] = lc
    gdep = depths[first[order]]
    grow_ = rows[first[order]]

    ent = node_entropy(fmat, d)
    if cfg.emax > 0:
        ok = (ent >= cfg.emin) & (ent <= cfg.emax)
    else:
        ok = np.ones(m, dtype=bool)
    active = fmat > 0
    # left-branching gate (metaserver.cpp:418-419): concrete-base
    # aggregate leftChar (same code on every active reader) is rejected
    lc_min = np.where(active, lcmat, 99).min(axis=1)
    lc_max = np.where(active, lcmat, -1).max(axis=1)
    lc_agg = np.where(lc_min == lc_max, lc_max, 1)  # 1 == LC_N
    ok &= lc_agg < 2
    keep = np.flatnonzero(ok)
    paths = _decode_rows(state, ph, seg_depth0, grow_[keep], gdep[keep])
    for j, i in enumerate(keep):
        act = np.flatnonzero(active[i])
        if act.size == 0:
            # defensively unreachable: staged rows always carry >= 1
            # active reader (present requires nact > 0), but a wrapped
            # histogram index would silently corrupt the stats
            continue
        if tracker is None:
            order, ent_val = act, float(ent[i])
        else:
            order = tracker.order_for(paths[j])
            ent_val = tracker.entropy_for(paths[j], fmat[i], d)
        out.total_output += 1
        out.freq_histogram[act.size - 1] += 1
        occs = [(int(r), int(fmat[i, r])) for r in order]
        out.total_occs += len(occs)
        out.lines.append((paths[j], ent_val, occs))


def _pull_dense_frontier(state):
    """Densify the live pair list to (nnodes, S) numpy interval arrays
    (tail handoff and checkpoints use the dense layout)."""
    import jax

    n = int(state["nnodes"])
    m = int(state["npairs"])
    p = int(state["parity"])
    prs = jax.device_get(state["pr"][p, :m])
    return (n, prs[:, PC_LO], prs[:, PC_HI], prs[:, PC_RLO],
            prs[:, PC_SID], prs[:, PC_NID])


def _handoff_tail(indexes, cfg, prefix, out, state, ph: PathHistory,
                  seg_depth0: int, debug=False, tracker=None) -> None:
    """FLAG_TAIL: pull the (narrow) frontier and finish on the host
    (engine_np.mine_from_level) — thousands of thin deep levels cost
    microseconds each there vs a full device step each here."""
    from .engine_np import _Level, mine_from_level

    depth = int(state["depth"])
    n, lo, hi, rlo, sid, nid = _pull_dense_frontier(state)
    S = len(indexes)
    lo_d = np.zeros((n, S), dtype=np.int64)
    hi_d = np.zeros((n, S), dtype=np.int64)
    rlo_d = np.zeros((n, S), dtype=np.int64)
    lo_d[nid, sid] = lo
    hi_d[nid, sid] = hi
    rlo_d[nid, sid] = rlo
    paths = _decode_rows(state, ph, seg_depth0, np.arange(n),
                         np.full(n, depth))
    level = _Level(paths=paths, lo=lo_d, hi=hi_d, rlo=rlo_d)
    if debug:
        t0 = time.perf_counter()
    mine_from_level(indexes, cfg, level, depth, out, prefix=prefix,
                    tracker=tracker)
    if debug:
        print(f"mine_device: host tail from depth {depth} width {n} "
              f"took {time.perf_counter() - t0:.2f}s",
              file=sys.stderr, flush=True)


def _apply_halt(state, ph: PathHistory, seg_depth0: int,
                prefixes: list[bytes], debug: bool = False) -> None:
    """Prune the live frontier under `prefixes` — the device form of
    the reference's server->client halt side channel
    (ServerSocket::writeHalt / TrieReader::sendHalt / checkHalt,
    ServerSocket.h:88-95, ClientSocket.h:48-77; vestigial there,
    SURVEY §5.3/§5.8: "the halt channel becomes a broadcast pruning
    mask applied to the next frontier").  Called at episode exits: the
    current frontier's paths are decoded, nodes under a halted prefix
    get their pairs' intervals emptied (hi := lo), and the subtree
    disappears from the next level on.  The halted nodes' own emission
    already happened when their level committed, matching the
    reference's stop-below-this-node semantics."""
    import jax.numpy as jnp

    if not prefixes:
        return
    n = int(state["nnodes"])
    m = int(state["npairs"])
    if n == 0 or m == 0:
        return
    depth = int(state["depth"])
    paths = _decode_rows(state, ph, seg_depth0, np.arange(n),
                         np.full(n, depth))
    kill_node = np.zeros(n, dtype=bool)
    for i, p in enumerate(paths):
        for pre in prefixes:
            if p.startswith(pre):
                kill_node[i] = True
                break
    if not kill_node.any():
        return
    par = int(state["parity"])
    prs = np.asarray(state["pr"][par, :m])
    kill_pair = kill_node[np.minimum(prs[:, PC_NID], n - 1)] \
        & (np.arange(m) < m)
    idx = np.flatnonzero(kill_pair)
    if debug:
        print(f"mine_device: halt prunes {kill_node.sum()} nodes / "
              f"{idx.size} pairs at depth {depth}", file=sys.stderr)
    # pad the scatter to a pow2 width so jit caches stay bounded; the
    # padding repeats a real index with its own lo (idempotent)
    w = _next_pow2(max(idx.size, 1))
    pad = np.full(w, idx[0], dtype=np.int64)
    pad[:idx.size] = idx
    lo_vals = prs[pad, PC_LO]
    state["pr"] = state["pr"].at[par, jnp.asarray(pad), PC_HI].set(
        jnp.asarray(lo_vals))


def _resize_state(state, dev: DeviceIndexes, cap: int, hist_cap: int):
    """Rare safety path (frontier exceeded CAP_MAX): re-bucket every
    capacity-dependent buffer on device, preserving the live pair list
    and the current history segment."""
    fresh = _seed_episode(dev, cap, hist_cap)
    out = dict(fresh)
    # eskip must survive the resize: a checkpoint resumed mid-burst can
    # grow with eskip > 0, and resetting it would re-emit (duplicate)
    # the already-drained chunk rows
    for k in ("parity", "npairs", "nnodes", "depth", "hist_len", "nlev",
              "ocount", "total_paths", "ent_min", "ent_max", "flag",
              "lvl_off", "boost", "eskip"):
        out[k] = state[k]
    ncopy = min(state["pr"].shape[1], fresh["pr"].shape[1])
    out["pr"] = fresh["pr"].at[:, :ncopy].set(state["pr"][:, :ncopy])
    ncopy = min(state["nb"].shape[1], fresh["nb"].shape[1])
    out["nb"] = fresh["nb"].at[:, :ncopy].set(state["nb"][:, :ncopy])
    hn = min(state["hist"].shape[0], fresh["hist"].shape[0])
    out["hist"] = fresh["hist"].at[:hn].set(state["hist"][:hn])
    on = min(state["out"].shape[0], fresh["out"].shape[0])
    out["out"] = fresh["out"].at[:on].set(state["out"][:on])
    return out


def mine_device(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    prefix: bytes = b"",
    dev: DeviceIndexes | None = None,
    cap: int = DEV_MIN_CAP,
    tail_width: int = TAIL_WIDTH,
    out_reserve: int = OUT_RESERVE,
    checkpoint: str | None = None,
    reader_order: str = "ascending",
    halt=None,
) -> MinedOutput:
    """Mine with the device-resident episode loop, handing narrow deep
    frontiers to the host wavefront.  Output lines/stats match
    engine_np.mine_np exactly except smallest/largest-entropy
    diagnostics, which are f32-accurate for the device-emitted part.

    reader_order='gnu' emits byte-exactly like the reference server
    (libstdc++ set-iteration reader order, matching entropy accumulation
    order): gated nodes are sparse, so their orders are reconstructed
    post hoc per emitted path (mining/gnulazy.py) — the episode itself
    runs identically.

    `cap` is a floor; the actual fixed node capacity is next_pow2(sum of
    text lengths) clamped to CAP_MAX, which no union level can exceed,
    so the episode compiles once and runs without grow/resize exits.

    `halt`: optional steering callback `halt(depth, out) -> list of
    path prefixes`, polled at every episode exit — the reference's
    (vestigial) server->client halt side channel as a frontier pruning
    mask (_apply_halt; ServerSocket.h:88-95, SURVEY §5.8).  Subtrees
    under returned prefixes stop being explored from the next level on.

    `checkpoint`: path to a snapshot written at every drain-type episode
    exit and resumed from automatically when the file exists
    (mining/checkpoint.py); `out_reserve` lowers the drain threshold
    (more frequent exits -> finer checkpoints; values above the
    OUT_RESERVE buffer constant are clamped down to it because the
    buffers are sized from the constant)."""
    import jax.numpy as jnp

    cfg.validate()
    if dev is None:
        dev = DeviceIndexes.build(indexes)
    if dev.S > MAX_SAMPLES:
        raise ValueError(
            f"mine_device supports at most {MAX_SAMPLES} samples "
            f"(got {dev.S}): the int32 entropy fixed-point windows "
            "(_nln_windows) guarantee exactness only to that bound "
            "(the reference caps a server at 273 readers, "
            "metaserver.cpp:19)")
    d = dev.S
    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    tracker = None
    if reader_order == "gnu":
        from .gnulazy import LazyGnuOrder

        tracker = LazyGnuOrder(indexes, cfg.fmin, d,
                               server_prefix_len=max(1, len(prefix)))
    elif reader_order != "ascending":
        raise ValueError(f"unknown reader_order {reader_order!r}")
    prefix_codes = tuple(EXT_CHARS.index(b) for b in prefix)
    sc = _Scalars.build(cfg, tail_width=tail_width,
                        out_reserve=min(out_reserve, OUT_RESERVE),
                        prefix_codes=prefix_codes)
    debug = os.environ.get("DSM_DEBUG") == "1"
    # SURVEY §5.1: DSM_TRACE=<dir> wraps the mining episodes in a JAX
    # profiler trace (device timeline; summarize the .xplane.pb under
    # <dir>/plugins/profile/ with tools/trace_summary.py)
    trace_dir = os.environ.get("DSM_TRACE")
    if trace_dir:
        import jax as _jax

        _jax.profiler.start_trace(trace_dir)

    def _stop_trace() -> None:
        if trace_dir:
            import jax as _jax2

            _jax2.profiler.stop_trace()
    t0 = time.perf_counter()

    cap = _auto_cap(dev, cap)
    hist_cap = _hist_cap(dev)
    state = _seed_episode(dev, cap, hist_cap)
    ph = PathHistory()
    seg_depth0 = 0
    if checkpoint is not None and os.path.exists(checkpoint):
        from .checkpoint import load_checkpoint

        host_state, out, base_paths = load_checkpoint(checkpoint, cfg,
                                                      prefix, dev.ns)
        cap = _auto_cap(dev, max(int(host_state["nvalid"]), cap))
        fresh = _seed_episode(dev, cap, hist_cap)
        # the snapshot stores the sparse pair rows directly (sorted by
        # node id with contiguous runs, as the episode requires)
        prh = np.asarray(host_state.pop("pairs"), dtype=np.int32)
        # snapshots may come from a differently-sharded run: recompute
        # the per-pair table offsets from this run's sample layout
        prh[:, PC_SOFF] = np.asarray(dev.soff)[prh[:, PC_SID]]
        k = prh.shape[0]
        fresh["pr"] = fresh["pr"].at[0, :k].set(prh)
        fresh["npairs"] = jnp.asarray(k, jnp.int32)
        n_nodes = int(host_state.pop("nvalid"))
        fresh["nnodes"] = jnp.asarray(n_nodes, jnp.int32)
        nb_host = np.concatenate(
            [[0], np.cumsum(np.bincount(prh[:, PC_NID],
                                        minlength=n_nodes))]
        ).astype(np.int32)
        fresh["nb"] = fresh["nb"].at[0, :n_nodes + 1].set(nb_host)
        for key, v in host_state.items():
            fresh[key] = jnp.asarray(v)
        fresh["parity"] = jnp.asarray(0, jnp.int32)
        fresh["flag"] = jnp.asarray(FLAG_RUN, jnp.int32)
        state = fresh
        seg_depth0 = int(state["depth"])
        ph = PathHistory(base_depth=seg_depth0, base_paths=base_paths)
        if debug:
            print(f"mine_device: resumed depth={seg_depth0} "
                  f"nnodes={int(state['nnodes'])}", file=sys.stderr)

    def _save() -> None:
        if checkpoint is not None:
            import jax

            from .checkpoint import save_checkpoint

            n = int(state["nnodes"])
            m = int(state["npairs"])
            p = int(state["parity"])
            prs = np.asarray(jax.device_get(state["pr"][p, :m]))
            live_paths = _decode_rows(state, ph, seg_depth0, np.arange(n),
                                      np.full(n, int(state["depth"])))
            view = dict(state, pairs=prs, nvalid=state["nnodes"])
            save_checkpoint(checkpoint, view, out, cfg, prefix, dev.ns,
                            live_paths)

    while True:
        fn = _jitted_episode(cap, hist_cap, dev.S)
        state = fn(dev.frowsT, dev.rrowsT, state, *sc.flat())
        flag = int(state["flag"])
        if debug:
            print(f"mine_device: flag={flag} cap={cap} "
                  f"depth={int(state['depth'])} nnodes={int(state['nnodes'])}"
                  f" npairs={int(state['npairs'])}"
                  f" ocount={int(state['ocount'])} "
                  f"t={time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        if flag == FLAG_GROW:
            if cap >= CAP_GROW_MAX:
                raise ValueError(
                    f"frontier exceeds single-episode capacity (cap "
                    f"{cap} is the growth ceiling CAP_GROW_MAX): "
                    "partition the trie by prefix — mine per enforced "
                    "prefix and concatenate (mine_device(prefix=...), "
                    "parallel/mesh.py, the reference's own 4^k-server "
                    "topology) — or shard samples "
                    "(parallel/engine_episode.py)")
            cap = min(cap * GROWTH, CAP_GROW_MAX)
            state = _resize_state(state, dev, cap, hist_cap)
            state["flag"] = jnp.asarray(FLAG_RUN, jnp.int32)
            continue
        if flag == FLAG_DONE:
            _drain(out, cfg, d, state, ph, seg_depth0, dev, tracker)
            break
        if flag == FLAG_TAIL:
            _drain(out, cfg, d, state, ph, seg_depth0, dev, tracker)
            if halt is not None:
                _apply_halt(state, ph, seg_depth0,
                            halt(int(state["depth"]), out), debug)
            # fold device-side stats in BEFORE the host tail refines them
            out.total_paths += int(state["total_paths"])
            em, eM = float(state["ent_min"]), float(state["ent_max"])
            if np.isfinite(em):
                out.smallest_entropy = min(out.smallest_entropy, em)
            if np.isfinite(eM):
                out.largest_entropy = max(out.largest_entropy, eM)
            _handoff_tail(indexes, cfg, prefix, out, state, ph, seg_depth0,
                          debug=debug, tracker=tracker)
            if checkpoint is not None and os.path.exists(checkpoint):
                os.unlink(checkpoint)
            _stop_trace()
            out.sort_postorder()
            return out
        if flag == FLAG_DRAIN:
            _drain(out, cfg, d, state, ph, seg_depth0, dev, tracker)
            if halt is not None:
                _apply_halt(state, ph, seg_depth0,
                            halt(int(state["depth"]), out), debug)
            _save()
        elif flag == FLAG_HISTFULL:
            # outputs reference the current segment: decode them first,
            # then pull the finished levels and reset the device segment
            _drain(out, cfg, d, state, ph, seg_depth0, dev, tracker)
            if halt is not None:
                _apply_halt(state, ph, seg_depth0,
                            halt(int(state["depth"]), out), debug)
            _pull_segment(ph, seg_depth0, state)
            seg_depth0 = int(state["depth"])
            _save()
        state["flag"] = jnp.asarray(FLAG_RUN, jnp.int32)

    out.total_paths = int(state["total_paths"])
    em, eM = float(state["ent_min"]), float(state["ent_max"])
    out.smallest_entropy = em if np.isfinite(em) else 1000.0
    out.largest_entropy = eM if np.isfinite(eM) else -1000.0
    if checkpoint is not None and os.path.exists(checkpoint):
        os.unlink(checkpoint)
    _stop_trace()
    out.sort_postorder()
    return out
