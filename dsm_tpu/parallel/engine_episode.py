"""Multi-device device-resident mining: the episode loop under shard_map.

Unifies the two halves the reference keeps separate — the fast
device-resident wavefront episode (mining/engine_device.py: no per-level
host round-trips, device history, drain/tail exits) and multi-device
sample sharding (parallel/engine_sharded.py: the d-stream trie merge as
psums over a mesh, metaserver.cpp:269-486 at 256-process scale).

Layout under `shard_map` over a ('samples',) mesh axis:

  * occ tables: each shard holds its samples' fused rows (padded to a
    common per-sample row count so the sample axis shards evenly);
  * pair list / nb / outputs: per shard, holding only that shard's
    sample pairs — the same packed rows as the single-device episode,
    with LOCAL sample ids (global id = shard * S_loc + local);
  * per-node statistics (freq sums, entropy fixed-point windows,
    per-symbol child counts, active-reader counts) are boundary
    differences of local prefix sums, psum'd over the samples axis —
    the one collective per level (one (B, 8) int32 all-reduce + scalar
    any-reduces for the exit flags).  Everything derived from psum'd
    values (union child numbering, output gates, history entries, exit
    flags, the level's bucket) is bitwise identical on every shard, so
    control flow stays uniform and the parent-pointer history can be
    kept replicated;
  * pair compaction, output emission and nb maintenance stay local.

The driver mirrors mine_device: drain exits pull each shard's gated
pairs (left-branching gate via a shard_map'd leftchar kernel), re-check
entropy in exact f64 on the host, decode paths from the replicated
history; the deep thin tail is handed to the host wavefront.

Semantics: engine_np.mine_np in ascending reader order — differentially
tested against the oracle on the 8-virtual-device CPU mesh
(tests/test_sharded.py) and byte-parity-chained to the reference
binaries through it.
"""

from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np

from ..index.alphabet import EXT_CHARS
from ..index.fmindex import FMIndex
from ..mining.config import MiningConfig
from ..mining.engine import leftchar_codes_pairsT
from ..mining.engine_np import MinedOutput, node_entropy
from ..mining.engine_device import (
    FLAG_DONE,
    FLAG_DRAIN,
    FLAG_GROW,
    FLAG_HISTFULL,
    FLAG_RUN,
    FLAG_TAIL,
    GROWTH,
    LB_MIN,
    MAX_SAMPLES,
    OC_DEPTH,
    OC_FREQ,
    OC_RLO,
    OC_ROW,
    OC_SID,
    OUT_RESERVE,
    PAIR_HEADROOM,
    PC_HI,
    PC_LO,
    PC_NID,
    PC_RLO,
    PC_SID,
    PC_SOFF,
    TAIL_WIDTH,
    PathHistory,
    bucket_ladder,
    _decode_rows,
    _hist_cap,
    _level_sharded,
    _next_pow2,
    _pull_segment,
    _Scalars,
    _seed_episode,
)
from ..ops.rank import ROWW
from .engine_sharded import ShardedIndexes
from .mesh import SAMPLES_AXIS


def _shard_map(f, mesh, in_specs, out_specs):
    import jax

    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


# state keys sharded over the samples axis (leading mesh dim outside the
# shard body); everything else is replicated (identical on every shard)
_SHARDED_KEYS = ("pr", "nb", "out", "npairs", "ocount")


def _specs(mesh):
    from jax.sharding import PartitionSpec as P

    sh = P(SAMPLES_AXIS)
    rep = P()
    state_spec = {k: (sh if k in _SHARDED_KEYS else rep)
                  for k in ("pr", "nb", "parity", "npairs", "nnodes",
                            "depth", "hist", "hist_len", "lvl_off", "nlev",
                            "out", "ocount", "total_paths", "ent_min",
                            "ent_max", "flag", "boost", "eskip")}
    return sh, rep, state_spec


@functools.cache
def _jitted_episode_sharded(mesh, cap: int, hist_cap: int, S_loc: int,
                            s_total: int = 0):
    import jax
    import jax.numpy as jnp
    from jax import lax

    ladder = bucket_ladder(PAIR_HEADROOM * cap)
    sh, rep, state_spec = _specs(mesh)

    def shard_body(frowsT, rrowsT, state, *flat_scalars):
        # tables shard on their leading sample axis; the sharded STATE
        # leaves carry an explicit leading shard dim instead (stripped
        # here, restored on return).  Per-pair table offsets ride in the
        # pair rows (PC_SOFF) and C4 is baked into the tables, so the
        # body needs no per-sample meta at all.  The per-shard flat
        # TRANSPOSED table (ops/rank.occ_cumT layout: column s*nbp+b
        # holds sample s's block b) is materialized once per episode
        # invocation — a table-sized copy amortized over the whole
        # while loop.
        state = {k: (v[0] if k in _SHARDED_KEYS else v)
                 for k, v in state.items()}
        S_l, nbp = frowsT.shape[0], frowsT.shape[2]
        frowsT_flat = frowsT.transpose(1, 0, 2).reshape(ROWW, S_l * nbp)
        sc = _Scalars(*flat_scalars)

        def cond(st):
            return st["flag"] == FLAG_RUN

        def body(st):
            np_max = lax.pmax(st["npairs"], SAMPLES_AXIS)
            need = jnp.maximum(np_max, st["nnodes"] + 1)
            lad = jnp.asarray(ladder, jnp.int32)
            k = jnp.clip(jnp.sum(lad < need) + st["boost"], 0,
                         len(ladder) - 1)
            branches = [
                functools.partial(_level_sharded, b, frowsT_flat,
                                  s_total, sc, hist_cap, SAMPLES_AXIS)
                for b in ladder
            ]
            return lax.switch(k, branches, st)

        state = lax.while_loop(cond, body, state)
        return {k: (v[None] if k in _SHARDED_KEYS else v)
                for k, v in state.items()}

    fn = _shard_map(
        shard_body, mesh,
        in_specs=(sh, sh, state_spec) + (rep,) * 12,
        out_specs=state_spec)
    return jax.jit(fn, donate_argnums=(2,))


# the sharded level's per-bucket temps are fatter than the single-device
# level's (exists-lattice childrows, dense (4B, 8) gathers, replicated
# history), so both the auto clamp and the growth ceiling sit one notch
# below engine_device's; they bound the compiled program's memory and
# are not yet measured on the GPU
SHARDED_CAP_MAX = 1 << 21
SHARDED_CAP_GROW_MAX = 1 << 22


def _auto_cap_sharded(dev, floor: int) -> int:
    """Fixed node capacity, mirroring engine_device._auto_cap: no union
    level exceeds the total indexed length (clamped; FLAG_GROW regrows
    past the clamp up to SHARDED_CAP_GROW_MAX)."""
    total = int(np.asarray(dev.ns).sum())
    return max(1 << LB_MIN, _next_pow2(floor),
               min(max(_next_pow2(total + 1) // 4, 1 << LB_MIN),
                   SHARDED_CAP_MAX))


def _single_controller() -> bool:
    """True when every mesh device belongs to this process — then a
    sharded array's per-shard slices are directly addressable and the
    drain can pull O(own shard) bytes instead of replicating everything
    to every device (VERDICT r3 weak #6)."""
    import jax

    return jax.process_count() == 1


@functools.cache
def _jitted_gather_counts(mesh):
    """All-gather the per-shard (ocount, npairs) scalars so every host
    can read them (multi-controller: direct device_get of a remote
    shard is illegal; a replicated gather is addressable everywhere)."""
    import jax
    from jax.sharding import PartitionSpec as P

    def body(oc, np_):
        from jax import lax

        g1 = lax.all_gather(oc[0], SAMPLES_AXIS)
        g2 = lax.all_gather(np_[0], SAMPLES_AXIS)
        return g1, g2

    fn = _shard_map(body, mesh,
                    in_specs=(P(SAMPLES_AXIS), P(SAMPLES_AXIS)),
                    out_specs=(P(), P()))
    return jax.jit(fn)


@functools.cache
def _jitted_gather_rows(mesh):
    """All-gather a per-shard packed-row slice to every host."""
    import jax
    from jax.sharding import PartitionSpec as P

    def body(rows):
        from jax import lax

        return lax.all_gather(rows[0], SAMPLES_AXIS)

    fn = _shard_map(body, mesh, in_specs=(P(SAMPLES_AXIS),),
                    out_specs=P())
    return jax.jit(fn)


@functools.cache
def _jitted_lc_sharded(mesh, replicate: bool = True):
    """Per-shard leftChar codes for the drained out rows.  With
    `replicate` the result is all-gathered (multi-controller drains need
    every host to see it); without, it stays sharded and each shard's
    slice is pulled locally — O(own shard) traffic."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def shard_lc(rrowsT, rows):
        from jax import lax

        S_l, nbp = rrowsT.shape[0], rrowsT.shape[2]
        rflatT = rrowsT.transpose(1, 0, 2).reshape(ROWW, S_l * nbp)
        soff = jnp.arange(S_l, dtype=jnp.int32) * nbp
        sid = rows[0][:, OC_SID]
        lc = leftchar_codes_pairsT(rflatT, soff[sid], rows[0][:, OC_RLO],
                                   rows[0][:, OC_FREQ])
        if replicate:
            return lax.all_gather(lc, SAMPLES_AXIS)
        return lc[None]

    fn = _shard_map(shard_lc, mesh,
                    in_specs=(P(SAMPLES_AXIS), P(SAMPLES_AXIS)),
                    out_specs=P() if replicate else P(SAMPLES_AXIS))
    return jax.jit(fn)


def _seed_sharded_episode(dev: ShardedIndexes, n_shards: int, cap: int,
                          hist_cap: int):
    """Per-shard episode states stacked on a leading shard axis.

    Seeds shard k's pair list with its S_loc samples (local sample ids
    0..S_loc-1, global id = k*S_loc + local); PC_SOFF carries the local
    table row offset (local_sid * rows-per-sample)."""
    import jax.numpy as jnp

    S_loc = dev.S // n_shards
    nbp = int(dev.fnp.shape[1])
    # borrow the single-device seeder for shapes, then fix the seeds
    class _Fake:
        S = S_loc
        ns = np.ones(S_loc, dtype=np.int64)
        soff = np.zeros(S_loc, dtype=np.int32)
    base = _seed_episode(_Fake, cap, hist_cap)
    stacked = {}
    ns = np.asarray(dev.ns, dtype=np.int64)
    # the big buffers are allocated ON DEVICE (jnp.zeros) and only the
    # tiny seed rows are shipped from the host
    seed = np.zeros((n_shards, S_loc, 8), dtype=np.int32)
    loc = np.arange(S_loc)
    for sh in range(n_shards):
        seed[sh, :, PC_HI] = ns[sh * S_loc:(sh + 1) * S_loc]
        seed[sh, :, PC_SID] = loc
        seed[sh, :, PC_SOFF] = loc * nbp
    stacked["pr"] = (jnp.zeros((n_shards,) + base["pr"].shape, jnp.int32)
                     .at[:, 0, :S_loc, :].set(jnp.asarray(seed)))
    stacked["nb"] = (jnp.zeros((n_shards,) + base["nb"].shape, jnp.int32)
                     .at[:, 0, 1].set(S_loc))
    stacked["npairs"] = jnp.full((n_shards,), S_loc, jnp.int32)
    stacked["ocount"] = jnp.zeros((n_shards,), jnp.int32)
    stacked["out"] = jnp.zeros((n_shards,) + base["out"].shape, jnp.int32)
    out = dict(base)
    out.update(stacked)
    return out


def _drain_sharded(out: MinedOutput, cfg: MiningConfig, d: int, state,
                   ph: PathHistory, seg_depth0: int, dev: ShardedIndexes,
                   mesh, n_shards: int, tracker=None) -> None:
    """Pull every shard's gated pairs, map local sample ids to global,
    then the same f64 entropy re-gate + left-branching gate + on-device
    path decode as the single-device drain.

    Single-controller runs pull each shard's own slice directly —
    O(total gated pairs) transfer; only multi-controller runs pay the
    replicating all-gather (remote shards are not addressable there)."""
    import jax
    import jax.numpy as jnp

    ocounts, _ = _jitted_gather_counts(mesh)(state["ocount"],
                                             state["npairs"])
    ocounts = np.asarray(jax.device_get(ocounts))
    n_tot = int(ocounts.sum())
    if n_tot == 0:
        return
    S_loc = dev.S // n_shards
    npad = min(_next_pow2(int(ocounts.max())), state["out"].shape[1])
    out_slice = state["out"][:, :npad]
    single = _single_controller()
    lc_all = _jitted_lc_sharded(mesh, replicate=not single)(
        dev.rrowsT, out_slice)
    if single:
        # per-shard pulls of exactly the counted rows (sharded arrays:
        # slicing shard k touches only its device)
        orows = [np.asarray(jax.device_get(out_slice[k, :int(ocounts[k])]))
                 for k in range(n_shards)]
        lcs_all = [np.asarray(jax.device_get(lc_all[k, :int(ocounts[k])]))
                   for k in range(n_shards)]
    else:
        g = np.asarray(jax.device_get(_jitted_gather_rows(mesh)(out_slice)))
        orows = [g[k, :int(ocounts[k])] for k in range(n_shards)]
        lc_host = np.asarray(jax.device_get(lc_all))
        lcs_all = [lc_host[k, :int(ocounts[k])] for k in range(n_shards)]
    state["ocount"] = jnp.zeros_like(state["ocount"])

    freqs, sids, rows_, depths, lcs = [], [], [], [], []
    for k in range(n_shards):
        if not int(ocounts[k]):
            continue
        o = orows[k]
        freqs.append(o[:, OC_FREQ])
        sids.append(o[:, OC_SID] + k * S_loc)   # local -> global sample id
        rows_.append(o[:, OC_ROW])
        depths.append(o[:, OC_DEPTH])
        lcs.append(lcs_all[k])
    freq = np.concatenate(freqs)
    sid = np.concatenate(sids)
    rows = np.concatenate(rows_)
    depths = np.concatenate(depths)
    lc = np.concatenate(lcs)

    key = depths.astype(np.int64) << 32 | rows.astype(np.int64)
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    g = rank[inv]
    m = uniq.size
    fmat = np.zeros((m, dev.S), dtype=np.int64)
    fmat[g, sid] = freq
    lcmat = np.full((m, dev.S), -1, dtype=np.int64)
    lcmat[g, sid] = lc
    gdep = depths[first[order]]
    grow_ = rows[first[order]]

    fmat = fmat[:, :d]   # drop inert padding samples
    lcmat = lcmat[:, :d]
    ent = node_entropy(fmat, d)
    if cfg.emax > 0:
        ok = (ent >= cfg.emin) & (ent <= cfg.emax)
    else:
        ok = np.ones(m, dtype=bool)
    active = fmat > 0
    lc_min = np.where(active, lcmat, 99).min(axis=1)
    lc_max = np.where(active, lcmat, -1).max(axis=1)
    lc_agg = np.where(lc_min == lc_max, lc_max, 1)
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


def _gather_live_pairs(state, mesh, n_shards: int):
    """Per-shard live pair rows (host numpy): direct per-shard pulls in
    single-controller runs, replicated all-gather otherwise.  Returns
    (list of (m_k, 8) arrays, per-shard counts)."""
    import jax

    _, counts = _jitted_gather_counts(mesh)(state["ocount"],
                                            state["npairs"])
    counts = np.asarray(jax.device_get(counts))
    p = int(state["parity"])
    m = max(int(counts.max()), 1)
    sl = state["pr"][:, p, :m]
    if _single_controller():
        parts = [np.asarray(jax.device_get(sl[k, :int(counts[k])]))
                 for k in range(n_shards)]
    else:
        g = np.asarray(jax.device_get(_jitted_gather_rows(mesh)(sl)))
        parts = [g[k, :int(counts[k])] for k in range(n_shards)]
    return parts, counts


def _pull_dense_sharded(state, dev: ShardedIndexes, n_shards: int, mesh):
    """(nnodes, S) dense interval arrays from every shard's pair list."""
    n = int(state["nnodes"])
    S = dev.S
    S_loc = S // n_shards
    parts, _ = _gather_live_pairs(state, mesh, n_shards)
    lo_d = np.zeros((n, S), dtype=np.int64)
    hi_d = np.zeros((n, S), dtype=np.int64)
    rlo_d = np.zeros((n, S), dtype=np.int64)
    for k, o in enumerate(parts):
        gsid = o[:, PC_SID] + k * S_loc
        lo_d[o[:, PC_NID], gsid] = o[:, PC_LO]
        hi_d[o[:, PC_NID], gsid] = o[:, PC_HI]
        rlo_d[o[:, PC_NID], gsid] = o[:, PC_RLO]
    return n, lo_d, hi_d, rlo_d


def _stack_pairs_by_shard(pairs_global: np.ndarray, n_shards: int,
                          S_loc: int, n_nodes: int, prow: int, nbrow: int,
                          nbp: int):
    """Split canonical (nid-sorted, ascending global sid) pair rows into
    per-shard pr[0]/nb[0]/npairs arrays (local sample ids; PC_SOFF
    recomputed for this run's table layout — snapshots may come from a
    differently-sharded or single-device run)."""
    prs = np.zeros((n_shards, prow, 8), dtype=np.int32)
    nbs = np.zeros((n_shards, nbrow), dtype=np.int32)
    nps = np.zeros(n_shards, dtype=np.int32)
    shard_of = pairs_global[:, PC_SID] // S_loc
    for k in range(n_shards):
        rows = pairs_global[shard_of == k]
        m = rows.shape[0]
        loc = rows.copy()
        loc[:, PC_SID] -= k * S_loc
        loc[:, PC_SOFF] = loc[:, PC_SID] * nbp
        prs[k, :m] = loc
        nps[k] = m
        nbs[k, :n_nodes + 1] = np.concatenate(
            [[0], np.cumsum(np.bincount(rows[:, PC_NID],
                                        minlength=n_nodes))]
        ).astype(np.int32)
    return prs, nbs, nps


def _resize_sharded(state, dev: ShardedIndexes, n_shards: int,
                    new_cap: int, hist_cap: int, mesh):
    """FLAG_GROW recovery: re-bucket every capacity-dependent buffer at
    `new_cap`, preserving each shard's live pair list, the replicated
    history segment, and any undraned output rows (the stacked-layout
    port of engine_device._resize_state).  The overflowed level never
    committed, so the redo replays it at the larger capacity."""
    import jax
    import jax.numpy as jnp

    parts, _ = _gather_live_pairs(state, mesh, n_shards)
    ocounts, _ = _jitted_gather_counts(mesh)(state["ocount"],
                                             state["npairs"])
    ocounts = np.asarray(jax.device_get(ocounts))
    n_nodes = int(state["nnodes"])
    fresh = _seed_sharded_episode(dev, n_shards, new_cap, hist_cap)
    prow = fresh["pr"].shape[2]
    nbrow = fresh["nb"].shape[2]
    ocap = fresh["out"].shape[1]

    prs = np.zeros((n_shards, prow, 8), dtype=np.int32)
    nbs = np.zeros((n_shards, nbrow), dtype=np.int32)
    nps = np.zeros(n_shards, dtype=np.int32)
    outs = np.zeros((n_shards, ocap, 8), dtype=np.int32)
    old_out = None
    if int(ocounts.sum()):
        if _single_controller():
            old_out = [np.asarray(jax.device_get(
                state["out"][k, :int(ocounts[k])]))
                for k in range(n_shards)]
        else:
            npad = min(_next_pow2(max(int(ocounts.max()), 1)),
                       state["out"].shape[1])
            g = np.asarray(jax.device_get(
                _jitted_gather_rows(mesh)(state["out"][:, :npad])))
            old_out = [g[k, :int(ocounts[k])] for k in range(n_shards)]
    for k, rows in enumerate(parts):
        m = rows.shape[0]
        prs[k, :m] = rows
        nps[k] = m
        nbs[k, :n_nodes + 1] = np.concatenate(
            [[0], np.cumsum(np.bincount(rows[:, PC_NID],
                                        minlength=n_nodes))]
        ).astype(np.int32)
        if old_out is not None:
            outs[k, :old_out[k].shape[0]] = old_out[k]

    new = dict(fresh)
    new["pr"] = fresh["pr"].at[:, 0].set(jnp.asarray(prs))
    new["nb"] = fresh["nb"].at[:, 0].set(jnp.asarray(nbs))
    new["npairs"] = jnp.asarray(nps)
    new["out"] = jnp.asarray(outs)
    new["ocount"] = state["ocount"]
    new["parity"] = jnp.asarray(0, jnp.int32)
    # eskip rides along: resetting it after a mid-burst resume would
    # re-emit already-drained chunk rows (see engine_device._resize_state)
    for k in ("nnodes", "depth", "hist_len", "nlev", "lvl_off",
              "total_paths", "ent_min", "ent_max", "boost", "eskip"):
        new[k] = state[k]
    hn = min(state["hist"].shape[0], fresh["hist"].shape[0])
    new["hist"] = fresh["hist"].at[:hn].set(state["hist"][:hn])
    new["flag"] = jnp.asarray(FLAG_RUN, jnp.int32)
    return new


def mine_device_sharded(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    mesh=None,
    prefix: bytes = b"",
    cap: int = 1 << LB_MIN,
    tail_width: int = TAIL_WIDTH,
    out_reserve: int = OUT_RESERVE,
    checkpoint: str | None = None,
    reader_order: str = "ascending",
    verbose: bool = False,
) -> MinedOutput:
    """Device-resident episode mining over a samples-sharded mesh.

    Same output as engine_np.mine_np / mine_device (enforcepath
    `prefix`; reader_order='gnu' for byte-exact reference parity via
    post-hoc order reconstruction, mining/gnulazy.py).  Trie-prefix
    partitioning composes the way the reference composes it — run one
    episode per prefix shard (wrapper-SLURM/example-server.sh topology),
    each with its own mesh or host (parallel/multihost.py).

    `checkpoint` snapshots at every drain-type exit and resumes when the
    file exists; snapshots store GLOBAL sample ids in canonical (node,
    sample) order, so they interchange with single-device mine_device
    checkpoints and with runs at a different shard count.  Capacity
    overflow regrows and replays the uncommitted level (FLAG_GROW),
    matching the single-device engine.

    `verbose` reports on stderr which device holds which samples' tables.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    cfg.validate()
    if mesh is None:
        devs = jax.devices()
        mesh = Mesh(np.array(devs).reshape(len(devs)), (SAMPLES_AXIS,))
    if tuple(mesh.axis_names) != (SAMPLES_AXIS,):
        raise ValueError("mine_device_sharded wants a 1-D ('samples',) "
                         "mesh; prefix partitioning runs one episode per "
                         "prefix (see docstring)")
    n_shards = mesh.shape[SAMPLES_AXIS]
    d = len(indexes)
    # the GLOBAL bound is MAX_SAMPLES, not MAX_SAMPLES per shard: the
    # psum'd entropy fixed-point windows (engine_device._nln_windows)
    # stay int32-exact only for <= 512 total samples, and every gated
    # node (<= d global pairs) must fit one EMIT_W emit chunk or the
    # burst drain loop cannot advance.  The reference itself caps a
    # server at 273 readers (metaserver.cpp:19).
    if d > MAX_SAMPLES:
        raise ValueError(
            f"at most {MAX_SAMPLES} samples per mining episode (got {d}; "
            "the reference caps a server at 273 readers too, "
            "metaserver.cpp:19) — split the sample set across "
            "independent episodes and merge, or raise MAX_SAMPLES with "
            "a wider entropy fixed-point layout")
    pad_to = -(-d // n_shards) * n_shards
    dev = ShardedIndexes.build(
        indexes, pad_to=pad_to,
        sharding=NamedSharding(mesh, P(SAMPLES_AXIS)))
    S_loc = dev.S // n_shards
    real_ns = np.array([idx.n for idx in indexes], dtype=np.int64)

    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    tracker = None
    if reader_order == "gnu":
        from ..mining.gnulazy import LazyGnuOrder

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

    cap = _auto_cap_sharded(dev, cap)
    hist_cap = _hist_cap(type("F", (), {"ns": np.asarray(dev.ns)})())
    state = _seed_sharded_episode(dev, n_shards, cap, hist_cap)
    ph = PathHistory()
    seg_depth0 = 0
    if checkpoint is not None and os.path.exists(checkpoint):
        from ..mining.checkpoint import load_checkpoint

        host_state, out, base_paths = load_checkpoint(checkpoint, cfg,
                                                      prefix, real_ns)
        cap = max(cap, _next_pow2(int(host_state["nvalid"])))
        fresh = _seed_sharded_episode(dev, n_shards, cap, hist_cap)
        pairs = np.asarray(host_state.pop("pairs"), dtype=np.int32)
        n_nodes = int(host_state.pop("nvalid"))
        prs, nbs, nps = _stack_pairs_by_shard(
            pairs, n_shards, S_loc, n_nodes,
            fresh["pr"].shape[2], fresh["nb"].shape[2],
            int(dev.fnp.shape[1]))
        fresh["pr"] = fresh["pr"].at[:, 0].set(jnp.asarray(prs))
        fresh["nb"] = fresh["nb"].at[:, 0].set(jnp.asarray(nbs))
        fresh["npairs"] = jnp.asarray(nps)
        fresh["nnodes"] = jnp.asarray(n_nodes, jnp.int32)
        for key, v in host_state.items():
            fresh[key] = jnp.asarray(v)
        fresh["parity"] = jnp.asarray(0, jnp.int32)
        fresh["flag"] = jnp.asarray(FLAG_RUN, jnp.int32)
        state = fresh
        seg_depth0 = int(state["depth"])
        ph = PathHistory(base_depth=seg_depth0, base_paths=base_paths)
        if debug:
            print(f"mine_device_sharded: resumed depth={seg_depth0} "
                  f"nnodes={int(state['nnodes'])}", file=sys.stderr)

    def _save() -> None:
        if checkpoint is None:
            return
        from ..mining.checkpoint import save_checkpoint

        parts, _ = _gather_live_pairs(state, mesh, n_shards)
        glob = []
        for k, rows in enumerate(parts):
            g = rows.copy()
            g[:, PC_SID] += k * S_loc
            glob.append(g)
        pairs = np.concatenate(glob) if glob else np.zeros((0, 8), np.int32)
        # canonical order: by node id, ascending global sample id
        pairs = pairs[np.lexsort((pairs[:, PC_SID], pairs[:, PC_NID]))]
        n = int(state["nnodes"])
        live_paths = _decode_rows(state, ph, seg_depth0, np.arange(n),
                                  np.full(n, int(state["depth"])))
        view = {"pairs": pairs, "nvalid": state["nnodes"],
                "depth": state["depth"],
                "total_paths": state["total_paths"],
                "ent_min": state["ent_min"], "ent_max": state["ent_max"],
                "eskip": state["eskip"],
                "ocount": int(np.asarray(jax.device_get(
                    state["ocount"])).sum())}
        save_checkpoint(checkpoint, view, out, cfg, prefix, real_ns,
                        live_paths)

    frowsT, rrowsT = dev.frowsT, dev.rrowsT
    if verbose:
        print(f"mine_device_sharded: table shards {dev.placement('fT')}",
              file=sys.stderr, flush=True)
    while True:
        fn = _jitted_episode_sharded(mesh, cap, hist_cap, S_loc,
                                     s_total=d)
        state = fn(frowsT, rrowsT, state, *sc.flat())
        flag = int(state["flag"])
        if debug:
            print(f"mine_device_sharded: flag={flag} cap={cap} "
                  f"depth={int(state['depth'])} "
                  f"nnodes={int(state['nnodes'])} "
                  f"t={time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        if flag == FLAG_GROW:
            # rare: re-bucket at larger capacity, replay the live pairs
            if cap >= SHARDED_CAP_GROW_MAX:
                raise ValueError(
                    f"frontier exceeds the sharded episode's capacity "
                    f"ceiling (cap {cap}): partition the trie by prefix "
                    "(one episode per enforced prefix, parallel/mesh.py) "
                    "or use more shards")
            cap = min(cap * GROWTH, SHARDED_CAP_GROW_MAX)
            state = _resize_sharded(state, dev, n_shards, cap, hist_cap,
                                    mesh)
            continue
        if flag == FLAG_DONE:
            _drain_sharded(out, cfg, d, state, ph, seg_depth0, dev, mesh,
                           n_shards, tracker)
            break
        if flag == FLAG_TAIL:
            _drain_sharded(out, cfg, d, state, ph, seg_depth0, dev, mesh,
                           n_shards, tracker)
            out.total_paths += int(state["total_paths"])
            em, eM = float(state["ent_min"]), float(state["ent_max"])
            if np.isfinite(em):
                out.smallest_entropy = min(out.smallest_entropy, em)
            if np.isfinite(eM):
                out.largest_entropy = max(out.largest_entropy, eM)
            depth = int(state["depth"])
            n, lo_d, hi_d, rlo_d = _pull_dense_sharded(state, dev,
                                                       n_shards, mesh)
            paths = _decode_rows(state, ph, seg_depth0, np.arange(n),
                                 np.full(n, depth))
            from ..mining.engine_np import _Level, mine_from_level

            level = _Level(paths=paths, lo=lo_d[:, :d], hi=hi_d[:, :d],
                           rlo=rlo_d[:, :d])
            mine_from_level(indexes, cfg, level, depth, out, prefix=prefix,
                            tracker=tracker)
            if checkpoint is not None and os.path.exists(checkpoint):
                os.unlink(checkpoint)
            _stop_trace()
            out.sort_postorder()
            return out
        if flag == FLAG_DRAIN:
            _drain_sharded(out, cfg, d, state, ph, seg_depth0, dev, mesh,
                           n_shards, tracker)
            _save()
        elif flag == FLAG_HISTFULL:
            _drain_sharded(out, cfg, d, state, ph, seg_depth0, dev, mesh,
                           n_shards, tracker)
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
