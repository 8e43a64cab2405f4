"""Wavefront mining engine: device tables and the per-level step.

Replaces the reference's d client processes x recursive DFS x TCP trie
streams x lazy server merge (EnumerateQuery.cpp:151-238,
metaserver.cpp:269-486) with ONE level-synchronous breadth-first wavefront
over all samples at once:

  * All S per-sample BIDIRECTIONAL FM-indexes live stacked on device as
    fused cum-count/bitplane rows (ops/rank.py): one uint32 row per
    128-symbol block carries the sampled cumulative <=-counts and five
    thermometer bitplanes, so a single gather + masked popcounts answers
    every per-symbol occ and lexicographic prefix sum at once.
  * A union-trie frontier is a dense table of per-(node, sample) forward
    intervals (CAP, S) x2 plus the synchronized reverse-interval start
    (CAP, S) — the 2BWT replacement for the reference's four tracked
    left-extension intervals (EnumerateQuery.h:44-45); see
    mining/engine_np.py for the equivalence argument.
  * One jitted step expands a whole level with FOUR rank positions per
    (node, sample) — lo/hi in the forward index for the 4-way children
    (and, via prefix sums, the children's reverse starts), rlo/rlo+freq
    in the reverse index for the leftChar codes
    (EnumerateQuery.cpp:77-103) — then computes the right-branching child
    statistics (metaserver.cpp:416-417) and compacts surviving children
    into the next frontier with a stable sort.

The expansion/analysis/compaction cores below are shared with the
device-resident episode engine (mining/engine_device.py — the default
path, no per-level host round-trips) and the multi-device engine
(parallel/engine_sharded.py), which shards the sample axis over a mesh
and turns the child-statistic reductions into psums — the device form
of the reference's TCP trie-stream merge.

Frequencies f >= fmin pruning happens per sample exactly as the client
does (EnumerateQuery.cpp:186-190); activity propagates down paths because
pruned samples get zeroed intervals.  Output is byte-identical to
engine_np (differentially tested), which is byte-identical to the
reference pipeline (tests/test_parity.py).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from ..index.alphabet import EXT_CHARS
from ..index.fmindex import FMIndex
from ..ops.rank import BLOCK, LOG2_BLOCK, ROWW, fused_rows, occ_cum
from .config import MiningConfig
from .engine_np import LC_N, LC_ZERO, MinedOutput, emit_level

MIN_CAP = 1024
EXT4 = (2, 3, 4, 6)  # codes of A, C, G, T (alphabet.EXT_CODES as a tuple)
# Hard sample-count bound shared by the episode engines: the int32
# entropy fixed-point windows (engine_device._nln_windows) are exact only
# for <= 512 samples, and the reference itself caps a server at 273
# readers (metaserver.cpp:19).  Also bounds the (soff, sid) sort-operand
# packing below.
MAX_SAMPLES = 512
# engine_device packs a pair's occ-table row offset and sample id into
# ONE int32 sort operand (soff * MAX_SAMPLES + sid), so the stacked
# tables must keep soff * MAX_SAMPLES + MAX_SAMPLES - 1 < 2^31.
MAX_TABLE_ROWS = 2**31 // MAX_SAMPLES

def hbm_budget() -> int:
    """Per-device memory budget in bytes: DSM_HBM_BYTES when set, else
    90% of the `bytes_limit` the device reports in memory_stats().  CPU
    hosts get an effectively unbounded budget (host RAM is the limit and
    pages).  An accelerator that reports no limit raises: guessing a
    size would plan capacities for some other device."""
    env = os.environ.get("DSM_HBM_BYTES")
    if env:
        return int(env)
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return 1 << 62
    lim = (dev.memory_stats() or {}).get("bytes_limit")
    if not lim:
        raise RuntimeError(
            f"device {dev.device_kind!r} ({dev.platform}) reports no "
            "memory limit in memory_stats(); set DSM_HBM_BYTES to its "
            "usable memory in bytes")
    return int(lim * 0.9)


@dataclass
class DeviceIndexes:
    """S per-sample bidirectional occ tables stacked onto one device.

    Two device layouts of the same fused rows (fused_rows c4=: the
    per-sample C4 base constants are BAKED into the cum columns, so
    expansion needs no runtime C4 gather/add), materialized LAZILY so a
    run pays HBM only for the layout its engine touches:

      frows/rrows  (sum_s nb_s+1, ROWW) uint32 row-major — the
                   per-level legacy engine and oracle paths;
      frowsT/rrowsT  (ROWW, sum_s nb_s+1) transposed — the episode
                   engines' hot layout (ops/rank.occ_cumT: the column
                   gather makes every consumer a major-dim op).

    soff: (S,) int32 per-sample row offsets (same for both directions);
    C4/C4hi: (S, 4) int32 C[c] / C[c+1] for c in A,C,G,T (drain-side
    bookkeeping only — never added during expansion).
    """

    S: int
    ns: np.ndarray        # (S,) int64 text lengths
    fnp: np.ndarray       # host (R, ROWW) uint32
    rnp: np.ndarray
    soff: object
    C4: object
    C4hi: object

    def _layout(self, key: str, make):
        import jax.numpy as jnp

        cache = self.__dict__.setdefault("_cache", {})
        if key not in cache:
            cache[key] = jnp.asarray(make())
        return cache[key]

    @property
    def frows(self):
        return self._layout("f", lambda: self.fnp)

    @property
    def rrows(self):
        return self._layout("r", lambda: self.rnp)

    @property
    def frowsT(self):
        return self._layout("fT", lambda: np.ascontiguousarray(self.fnp.T))

    @property
    def rrowsT(self):
        return self._layout("rT", lambda: np.ascontiguousarray(self.rnp.T))

    @classmethod
    def build(cls, indexes: list[FMIndex], pad_to: int | None = None
              ) -> "DeviceIndexes":
        """Stack per-sample tables; optionally right-pad the sample axis to
        `pad_to` with inert dummy samples (single-terminator texts) so the
        axis divides a mesh dimension.  Dummies are never active (no
        A/C/G/T occurrences) and contribute exactly 0.0 to entropy."""
        import jax.numpy as jnp

        S_real = len(indexes)
        S = pad_to if pad_to is not None else S_real
        if S < S_real:
            raise ValueError("pad_to smaller than the number of samples")
        fparts, rparts, offs = [], [], []
        C4 = np.zeros((S, 4), dtype=np.int32)
        C4hi = np.zeros((S, 4), dtype=np.int32)
        ns = np.zeros(S, dtype=np.int64)
        off = 0
        for s, idx in enumerate(indexes):
            c4 = [idx.C[c] for c in EXT4]
            fr = fused_rows(idx.table, c4=c4)
            rr = fused_rows(idx.rtable, c4=c4)
            assert fr.shape == rr.shape
            fparts.append(fr)
            rparts.append(rr)
            offs.append(off)
            off += fr.shape[0]
            C4[s] = [idx.C[c] for c in EXT4]
            C4hi[s] = [idx.C[c + 1] for c in EXT4]
            ns[s] = idx.n
        dummy = np.zeros((1, ROWW), dtype=np.uint32)  # text "\0": cum rows 0
        for s in range(S_real, S):
            fparts.append(dummy)
            rparts.append(dummy)
            offs.append(off)
            off += 1
            ns[s] = 1
        if off >= MAX_TABLE_ROWS:
            raise ValueError(
                f"stacked occ tables need {off} rows, but the episode "
                f"engine's (soff, sid) sort-operand packing supports at "
                f"most {MAX_TABLE_ROWS - 1} (~{MAX_TABLE_ROWS * 128:,} "
                "indexed symbols per device); shard the sample axis "
                "over more devices (parallel/engine_episode.py) or "
                "mine per-prefix partitions (parallel/mesh.py)")
        resident = 2 * off * ROWW * 4
        budget = hbm_budget()
        if resident > budget:
            raise ValueError(
                f"resident occ tables need {resident:,} bytes but the "
                f"device budget is {budget:,} (DSM_HBM_BYTES overrides): "
                "shard the sample axis over more devices "
                "(parallel/engine_episode.py) or use "
                "mining.bigindex.mine_big, which plans sharding and "
                "falls back to the bounded-memory host engine")
        return cls(S=S, ns=ns,
                   fnp=np.concatenate(fparts),
                   rnp=np.concatenate(rparts),
                   soff=jnp.asarray(np.asarray(offs, dtype=np.int32)),
                   C4=jnp.asarray(C4), C4hi=jnp.asarray(C4hi))


def _occ_psum4(cum5, pos):
    """(occ4, psum4) at `pos` from cumulative <=-counts (ops/rank.py):
    per-extension-symbol occ and #{codes < c} for c in A,C,G,T."""
    import jax.numpy as jnp

    c1, c2, c3, c4, c5 = [cum5[..., j] for j in range(5)]
    occ4 = jnp.stack([c2 - c1, c3 - c2, c4 - c3, pos - c5], axis=-1)
    psum4 = jnp.stack([c1, c2, c3, c5], axis=-1)
    return occ4, psum4


def leftchar_codes_pairs(rrows, soff_pair, rlo, freq):
    """leftchar_codes for a flat (node, sample)-pair list: soff_pair is
    each pair's per-sample row offset (soff[sid]), same shape as
    rlo/freq (K,).  Returns (K,) int8 codes."""
    import jax.numpy as jnp

    rhi = rlo + freq
    rcum_lo = occ_cum(rrows, (rlo >> LOG2_BLOCK) + soff_pair,
                      rlo & (BLOCK - 1))
    rcum_hi = occ_cum(rrows, (rhi >> LOG2_BLOCK) + soff_pair,
                      rhi & (BLOCK - 1))
    rocc_lo, _ = _occ_psum4(rcum_lo, rlo)
    rocc_hi, _ = _occ_psum4(rcum_hi, rhi)
    rcnt = rocc_hi - rocc_lo                                 # (K, 4)
    is_full = (rcnt == freq[..., None]) & (freq[..., None] > 0)
    return jnp.where(
        is_full.any(axis=-1), jnp.argmax(is_full, axis=-1) + 2,
        jnp.where((rcnt > 0).any(axis=-1), LC_N, LC_ZERO),
    ).astype(jnp.int8)


def leftchar_codes_pairsT(rrowsT, soff_pair, rlo, freq):
    """leftchar_codes_pairs on the transposed table layout
    (DeviceIndexes.rrowsT / ops/rank.occ_cumT) — the episode drain's
    form.  Returns (K,) int8 codes."""
    import jax.numpy as jnp

    from ..ops.rank import occ_cumT

    rhi = rlo + freq
    clo5 = occ_cumT(rrowsT, (rlo >> LOG2_BLOCK) + soff_pair,
                    rlo & (BLOCK - 1))                        # (5, K)
    chi5 = occ_cumT(rrowsT, (rhi >> LOG2_BLOCK) + soff_pair,
                    rhi & (BLOCK - 1))
    d5 = chi5 - clo5
    rcnt = jnp.concatenate(
        [(d5[1] - d5[0])[None], (d5[2] - d5[1])[None],
         (d5[3] - d5[2])[None], (freq - d5[4])[None]], axis=0)  # (4, K)
    is_full = (rcnt == freq[None, :]) & (freq[None, :] > 0)
    return jnp.where(
        is_full.any(axis=0), jnp.argmax(is_full, axis=0) + 2,
        jnp.where((rcnt > 0).any(axis=0), LC_N, LC_ZERO),
    ).astype(jnp.int8)


def leftchar_codes(rrows, soff, rlo, freq):
    """leftChar codes (EnumerateQuery.cpp:77-103) from right-extension
    counts in the reverse index: a concrete base (code base+2) iff EVERY
    occurrence extends right with that base in the reversed text, LC_N if
    extensions are mixed-but-present, LC_ZERO if none (text boundary).

    rlo/freq: (..., S) int32 reverse-interval starts and widths."""
    import jax.numpy as jnp

    soff_b = soff[None, :]
    rhi = rlo + freq
    rcum_lo = occ_cum(rrows, (rlo >> LOG2_BLOCK) + soff_b, rlo & (BLOCK - 1))
    rcum_hi = occ_cum(rrows, (rhi >> LOG2_BLOCK) + soff_b, rhi & (BLOCK - 1))
    rocc_lo, _ = _occ_psum4(rcum_lo, rlo)
    rocc_hi, _ = _occ_psum4(rcum_hi, rhi)
    rcnt = rocc_hi - rocc_lo                                 # (..., S, 4)
    is_full = (rcnt == freq[..., None]) & (freq[..., None] > 0)
    return jnp.where(
        is_full.any(axis=-1), jnp.argmax(is_full, axis=-1) + 2,
        jnp.where((rcnt > 0).any(axis=-1), LC_N, LC_ZERO),
    ).astype(jnp.int8)


def expand_core(frows, rrows, soff, lo, hi, rlo, valid, fmin,
                with_lc: bool = True):
    """Shared per-shard expansion: 4-way LF of every (node, sample)'s
    forward interval, the children's synchronized reverse starts (prefix
    sums over the forward counts), and (with_lc) the node's own leftChar
    codes from the reverse index.  Works on whatever sample shard the
    tables and intervals hold (full set single-device; a mesh shard under
    shard_map).

    with_lc=False skips the two reverse-index rank positions — half the
    gather traffic; callers that gate outputs lazily (engine_device)
    compute leftchar_codes for the few candidate rows at drain time
    instead of for every node.

    lo/hi/rlo: (CAP, S) int32.  Returns a dict of local arrays:
      clo, chi, crlo (CAP, S, 4); cactive (CAP, S, 4) bool; freq (CAP, S);
      lc (CAP, S) int8 (with_lc only); nactive (CAP,) int32;
      child_counts (CAP, 4) int32.
    """
    import jax.numpy as jnp

    soff_b = soff[None, :]
    cum_lo = occ_cum(frows, (lo >> LOG2_BLOCK) + soff_b, lo & (BLOCK - 1))
    cum_hi = occ_cum(frows, (hi >> LOG2_BLOCK) + soff_b, hi & (BLOCK - 1))
    occ_lo, psum_lo = _occ_psum4(cum_lo, lo)
    occ_hi, psum_hi = _occ_psum4(cum_hi, hi)

    parent_active = (hi > lo) & valid[:, None]               # (CAP, S)
    pa3 = parent_active[:, :, None]
    # C4 is baked into the occ tables (fused_rows c4=): occ_lo/occ_hi
    # already ARE the child interval bounds
    clo = jnp.where(pa3, occ_lo, 0)
    chi = jnp.where(pa3, occ_hi, 0)
    crlo = jnp.where(pa3, rlo[:, :, None] + psum_hi - psum_lo, 0)
    cfreq = chi - clo
    cactive = pa3 & (cfreq >= fmin)                          # (CAP, S, 4)

    freq = hi - lo
    out = dict(
        clo=clo, chi=chi, crlo=crlo, cactive=cactive,
        freq=freq,
        nactive=(parent_active & (freq > 0)).sum(axis=1, dtype=jnp.int32),
        child_counts=cactive.sum(axis=1, dtype=jnp.int32),
    )
    if with_lc:
        out["lc"] = leftchar_codes(rrows, soff, rlo, freq)
    return out


def analyze_children(union_child, child_counts, nactive):
    """numchildren + the right-branching-violation flag
    (metaserver.cpp:416-417): exactly one distinct child symbol AND every
    active reader descends into it.  child_counts/nactive must already be
    global (psum'd) when samples are sharded."""
    import jax.numpy as jnp

    numchildren = union_child.sum(axis=-1)
    single_idx = jnp.argmax(union_child, axis=-1)
    single_full = (numchildren == 1) & (
        jnp.take_along_axis(child_counts, single_idx[..., None], axis=-1)[..., 0]
        == nactive
    )
    return single_full


def compact_children(union_child, core):
    """Select surviving children (u-major, A<C<G<T within a node) into the
    next frontier via a stable sort.  `union_child` must be globally
    consistent; the gathered state is per-shard.  Returns the next state
    plus parent_row/sym/child_count for host path bookkeeping."""
    import jax.numpy as jnp

    CAP = union_child.shape[0]
    S = core["clo"].shape[1]
    cv_flat = union_child.reshape(-1)                       # (CAP*4,)
    perm = jnp.argsort(jnp.logical_not(cv_flat), stable=True)
    child_count = cv_flat.sum()
    sel = perm[:CAP]
    parent_row = (sel // 4).astype(jnp.int32)
    sym = (sel % 4).astype(jnp.int32)
    valid_next = jnp.arange(CAP, dtype=jnp.int32) < child_count

    clo_f = core["clo"].transpose(0, 2, 1).reshape(CAP * 4, S)
    chi_f = core["chi"].transpose(0, 2, 1).reshape(CAP * 4, S)
    crlo_f = core["crlo"].transpose(0, 2, 1).reshape(CAP * 4, S)
    cact_f = core["cactive"].transpose(0, 2, 1).reshape(CAP * 4, S)
    keep = cact_f[sel] & valid_next[:, None]
    return dict(
        lo=jnp.where(keep, clo_f[sel], 0),
        hi=jnp.where(keep, chi_f[sel], 0),
        rlo=jnp.where(keep, crlo_f[sel], 0),
        valid=valid_next,
        parent_row=parent_row, sym=sym, child_count=child_count,
    )


def _level_step_impl(frows, rrows, soff, lo, hi, rlo, valid, fmin,
                     sym_mask):
    """Single-device step: expand + analyze + compact one frontier level."""
    core = expand_core(frows, rrows, soff, lo, hi, rlo, valid, fmin)
    union_child = (core["child_counts"] > 0) & sym_mask[None, :]   # (CAP, 4)
    single_full = analyze_children(union_child, core["child_counts"],
                                   core["nactive"])
    res = compact_children(union_child, core)
    res.update(freq=core["freq"], lc=core["lc"], single_full=single_full)
    return res


@functools.cache
def _jitted_level_step():
    import jax

    return jax.jit(_level_step_impl)


def _level_step(*args):
    return _jitted_level_step()(*args)


def _seed_state(dev: DeviceIndexes, cap: int):
    import jax.numpy as jnp

    S = dev.S
    lo = jnp.zeros((cap, S), dtype=jnp.int32)
    hi = jnp.zeros((cap, S), dtype=jnp.int32)
    hi = hi.at[0].set(jnp.asarray(dev.ns, dtype=jnp.int32))
    rlo = jnp.zeros((cap, S), dtype=jnp.int32)
    valid = jnp.zeros(cap, dtype=bool).at[0].set(True)
    return lo, hi, rlo, valid


def _resize(state, cap: int):
    import jax.numpy as jnp

    cur = state[0].shape[0]
    if cap == cur:
        return state
    if cap < cur:
        return tuple(a[:cap] for a in state)
    pad = cap - cur
    lo, hi, rlo, valid = state
    return (
        jnp.pad(lo, ((0, pad), (0, 0))),
        jnp.pad(hi, ((0, pad), (0, 0))),
        jnp.pad(rlo, ((0, pad), (0, 0))),
        jnp.pad(valid, (0, pad)),
    )


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def mine_tpu(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    prefix: bytes = b"",
    reader_order: str = "ascending",
    dev: DeviceIndexes | None = None,
    cap: int = MIN_CAP,
    checkpoint: str | None = None,
) -> MinedOutput:
    """Mine the cross-sample union trie on the accelerator.

    Same semantics and output as engine_np.mine_np (enforcepath via
    `prefix`, all MiningConfig gates).  Both reader orders dispatch to
    the device-resident episode loop (engine_device.mine_device — no
    per-level host round-trips, checkpoint/resume): 'gnu' (byte-exact
    reference parity) reconstructs set orders post hoc for the sparse
    emitted paths (mining/gnulazy.py).  reader_order='level-gnu' keeps
    the legacy per-level loop here, whose host emission drives the
    per-level order tracker — retained as a differential oracle for the
    lazy reconstruction (tests/test_gnuorder.py).
    """
    import jax.numpy as jnp

    cfg.validate()
    if reader_order in ("ascending", "gnu"):
        from .engine_device import mine_device

        return mine_device(indexes, cfg, prefix=prefix, dev=dev, cap=cap,
                           checkpoint=checkpoint,
                           reader_order=reader_order)
    if reader_order == "level-gnu":
        reader_order = "gnu"
    if checkpoint is not None:
        raise ValueError("checkpointing requires reader_order='ascending' "
                         "or 'gnu' (the episode engine); the legacy "
                         "'level-gnu' per-level loop has no checkpoints")
    if dev is None:
        dev = DeviceIndexes.build(indexes)
    d = dev.S
    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    tracker = None
    if reader_order == "gnu":
        from .gnuorder import GnuOrderTracker

        tracker = GnuOrderTracker(d, server_prefix_len=max(1, len(prefix)))

    fmin = jnp.asarray(cfg.fmin, dtype=jnp.int32)
    masks = {
        "all": jnp.ones(4, dtype=bool),
        "none": jnp.zeros(4, dtype=bool),
    }
    for ci in range(4):
        masks[ci] = jnp.zeros(4, dtype=bool).at[ci].set(True)
    prefix_codes = [EXT_CHARS.index(b) for b in prefix]

    state = _seed_state(dev, cap)
    paths: list[bytes] = [b""]
    depth = 0

    while True:
        if depth >= cfg.maxdepth:
            sym_mask = masks["none"]
        elif depth < len(prefix_codes):
            sym_mask = masks[prefix_codes[depth]]
        else:
            sym_mask = masks["all"]

        res = _level_step(dev.frows, dev.rrows, dev.soff, *state,
                          fmin, sym_mask)
        child_count = int(res["child_count"])
        if child_count > state[0].shape[0]:
            # frontier overflow: grow capacity and redo this level
            state = _resize(state, _next_pow2(child_count))
            continue

        if depth > 0:
            emit_level(
                out, cfg, d, depth,
                paths + [b""] * (state[0].shape[0] - len(paths)),
                np.asarray(res["freq"]).astype(np.int64),
                np.asarray(res["lc"]),
                np.asarray(res["single_full"]),
                tracker,
            )
        if child_count == 0:
            break

        parent_row = np.asarray(res["parent_row"][:child_count])
        sym = np.asarray(res["sym"][:child_count])
        if tracker is not None:
            child_act = np.asarray(
                res["hi"][:child_count] > res["lo"][:child_count])
            tracker.advance(
                depth, paths,
                [(int(u), int(c), child_act[j])
                 for j, (u, c) in enumerate(
                     zip(parent_row.tolist(), sym.tolist()))],
            )
        paths = [paths[u] + EXT_CHARS[c:c + 1]
                 for u, c in zip(parent_row.tolist(), sym.tolist())]
        state = (res["lo"], res["hi"], res["rlo"], res["valid"])
        # shrink toward the live width to keep deep narrow levels cheap
        want = max(MIN_CAP, _next_pow2(child_count))
        if want < state[0].shape[0]:
            state = _resize(state, want)
        depth += 1

    out.sort_postorder()
    return out
