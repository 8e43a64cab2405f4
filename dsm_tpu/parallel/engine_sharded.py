"""Multi-device wavefront mining: samples and trie prefixes on a mesh.

This is the device replacement for the reference's distributed
topology (SURVEY.md §5.8): d clients streaming serialized tries over TCP
into per-prefix merge servers becomes a single SPMD program on a
('prefix', 'samples') mesh:

  * occ tables are sharded over the samples axis — each device holds the
    FM-indexes of its sample shard (the reference's one-client-per-sample
    data parallelism, metaenumerate.cpp:268-309);
  * the per-level child-existence/child-count reductions — the information
    content of the reference's trie-stream merge (metaserver.cpp:159-189,
    325-339) — are psums over the samples axis;
  * frontier rows are replicated within a prefix row and disjoint across
    prefix rows (depth-0 symbol partitioning — the reference's
    enforcepath server sharding, wrapper-SLURM/example-server.sh).

The math is engine.expand_core / analyze_children / compact_children —
identical to the single-device step, so output parity chains through the
oracle to the reference binaries.
"""

from __future__ import annotations

import functools
import sys

import numpy as np

from dataclasses import dataclass

from ..index.alphabet import EXT_CHARS
from ..index.fmindex import FMIndex
from ..mining.config import MiningConfig
from ..mining.engine import (
    EXT4,
    MIN_CAP,
    MinedOutput,
    _next_pow2,
    analyze_children,
    compact_children,
    emit_level,
    expand_core,
)
from ..ops.rank import ROWW, fused_rows
from .mesh import (PREFIX_AXIS, SAMPLES_AXIS, default_mesh_shape, make_mesh,
                   prefix_depth, row_prefix_masks)


@dataclass
class ShardedIndexes:
    """Per-sample bidirectional tables padded to a COMMON row count so the
    sample axis is a shardable leading dimension (unequal samples are
    right-padded with inert zero rows that no in-range position gathers).

    Like mining.engine.DeviceIndexes, both device layouts are LAZY so a
    run pays device memory only for what its engine touches: frows/rrows
    (S, NBP, ROWW) row-major for the per-level legacy engine here, and
    frowsT/rrowsT (S, ROWW, NBP) for the sharded episode engine, whose
    shard body flattens them to the ops/rank.occ_cumT column layout.

    `sharding` (a NamedSharding over the sample axis) places each layout
    shard by shard as it is first built, so every device receives only
    its own samples' rows."""

    S: int
    ns: np.ndarray   # (S,) int64
    fnp: np.ndarray  # host (S, NBP, ROWW) uint32
    rnp: np.ndarray
    C4: object       # jnp (S, 4) int32
    C4hi: object
    sharding: object

    def _layout(self, key: str, make):
        import jax

        cache = self.__dict__.setdefault("_cache", {})
        if key not in cache:
            host = make()
            cache[key] = jax.make_array_from_callback(
                host.shape, self.sharding, lambda idx: host[idx])
        return cache[key]

    def placement(self, key: str) -> str:
        """"device:samples[a:b], ..." for the addressable shards of an
        already built layout ("f", "r", "fT" or "rT")."""
        shards = sorted(
            (sh.index[0].start or 0, sh.index[0].stop or self.S,
             str(sh.device))
            for sh in self.__dict__["_cache"][key].addressable_shards)
        return ", ".join(f"{d}:samples[{a}:{b}]" for a, b, d in shards)

    @property
    def frows(self):
        return self._layout("f", lambda: self.fnp)

    @property
    def rrows(self):
        return self._layout("r", lambda: self.rnp)

    @property
    def frowsT(self):
        return self._layout(
            "fT", lambda: np.ascontiguousarray(
                self.fnp.transpose(0, 2, 1)))

    @property
    def rrowsT(self):
        return self._layout(
            "rT", lambda: np.ascontiguousarray(
                self.rnp.transpose(0, 2, 1)))

    @classmethod
    def build(cls, indexes: list[FMIndex], sharding,
              pad_to: int | None = None) -> "ShardedIndexes":
        import jax.numpy as jnp

        S_real = len(indexes)
        S = pad_to if pad_to is not None else S_real
        if S < S_real:
            raise ValueError("pad_to smaller than the number of samples")
        fr = [fused_rows(idx.table, c4=[idx.C[c] for c in EXT4])
              for idx in indexes]
        rr = [fused_rows(idx.rtable, c4=[idx.C[c] for c in EXT4])
              for idx in indexes]
        nbp = max(a.shape[0] for a in fr)
        frows = np.zeros((S, nbp, ROWW), dtype=np.uint32)
        rrows = np.zeros((S, nbp, ROWW), dtype=np.uint32)
        C4 = np.zeros((S, 4), dtype=np.int32)
        C4hi = np.zeros((S, 4), dtype=np.int32)
        ns = np.ones(S, dtype=np.int64)  # dummies: text "\0"
        for s, idx in enumerate(indexes):
            frows[s, : fr[s].shape[0]] = fr[s]
            rrows[s, : rr[s].shape[0]] = rr[s]
            C4[s] = [idx.C[c] for c in EXT4]
            C4hi[s] = [idx.C[c + 1] for c in EXT4]
            ns[s] = idx.n
        return cls(S=S, ns=ns, fnp=frows, rnp=rrows, C4=jnp.asarray(C4),
                   C4hi=jnp.asarray(C4hi), sharding=sharding)


def _sharded_step_impl(frows, rrows, lo, hi, rlo, valid, fmin,
                       sym_mask):
    """shard_map body.  Local shapes (R = local prefix rows, S = local
    samples): frows/rrows (S, NBP, ROWW) with C4 baked in (fused_rows
    c4=), lo/hi/rlo (R, CAP, S), valid (R, CAP), sym_mask (R, 4)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    S_loc, nbp = frows.shape[0], frows.shape[1]
    soff = jnp.arange(S_loc, dtype=jnp.int32) * nbp
    frows_flat = frows.reshape(S_loc * nbp, ROWW)
    rrows_flat = rrows.reshape(S_loc * nbp, ROWW)

    core = jax.vmap(
        lambda lo_r, hi_r, rlo_r, valid_r: expand_core(
            frows_flat, rrows_flat, soff, lo_r, hi_r, rlo_r, valid_r,
            fmin)
    )(lo, hi, rlo, valid)

    # the "trie merge": global child stats via psum over the samples axis
    child_counts = lax.psum(core["child_counts"], SAMPLES_AXIS)  # (R, CAP, 4)
    nactive = lax.psum(core["nactive"], SAMPLES_AXIS)            # (R, CAP)
    union_child = (child_counts > 0) & sym_mask[:, None, :]
    single_full = analyze_children(union_child, child_counts, nactive)

    res = jax.vmap(compact_children)(
        union_child,
        {k: core[k] for k in ("clo", "chi", "crlo", "cactive")},
    )
    res.update(freq=core["freq"], lc=core["lc"], single_full=single_full)
    return res


@functools.cache
def _jitted_sharded_step(mesh):
    import jax
    from jax.sharding import PartitionSpec as P

    spec_tbl = P(SAMPLES_AXIS)                       # frows/rrows
    spec_iv = P(PREFIX_AXIS, None, SAMPLES_AXIS)     # lo/hi/rlo
    spec_row = P(PREFIX_AXIS)                        # valid/sym_mask
    fn = jax.shard_map(
        _sharded_step_impl,
        mesh=mesh, check_vma=False,
        in_specs=(spec_tbl, spec_tbl,
                  spec_iv, spec_iv, spec_iv, spec_row,
                  P(), spec_row),
        out_specs=dict(
            lo=spec_iv, hi=spec_iv, rlo=spec_iv,
            valid=spec_row,
            parent_row=spec_row, sym=spec_row,
            child_count=P(PREFIX_AXIS),
            freq=spec_iv, lc=spec_iv,
            single_full=spec_row,
        ),
    )
    return jax.jit(fn)


def _seed_sharded(dev: ShardedIndexes, n_rows: int, cap: int):
    import jax.numpy as jnp

    S = dev.S
    lo = jnp.zeros((n_rows, cap, S), dtype=jnp.int32)
    hi = jnp.zeros((n_rows, cap, S), dtype=jnp.int32)
    hi = hi.at[:, 0].set(jnp.asarray(dev.ns, dtype=jnp.int32)[None, :])
    rlo = jnp.zeros((n_rows, cap, S), dtype=jnp.int32)
    valid = jnp.zeros((n_rows, cap), dtype=bool).at[:, 0].set(True)
    return lo, hi, rlo, valid


def _resize_sharded(state, cap: int):
    import jax.numpy as jnp

    cur = state[0].shape[1]
    if cap == cur:
        return state
    if cap < cur:
        return tuple(a[:, :cap] for a in state)
    pad = cap - cur
    lo, hi, rlo, valid = state
    return (
        jnp.pad(lo, ((0, 0), (0, pad), (0, 0))),
        jnp.pad(hi, ((0, 0), (0, pad), (0, 0))),
        jnp.pad(rlo, ((0, 0), (0, pad), (0, 0))),
        jnp.pad(valid, ((0, 0), (0, pad))),
    )


def mine_sharded(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    mesh=None,
    cap: int = MIN_CAP,
    prefix: bytes = b"",
    reader_order: str = "ascending",
    verbose: bool = False,
) -> MinedOutput:
    """Mine on a device mesh: samples sharded + psum-merged, trie split
    into disjoint depth-0 prefix partitions per mesh row.  Output is
    identical to engine_np.mine_np / engine.mine_tpu, including the
    enforcepath `prefix` restriction (EnumerateQuery.cpp:240-290) and
    reader_order='gnu' byte-exact emission (one GnuOrderTracker per
    prefix row — rows see disjoint path sets, so per-row trackers equal
    the single-server replay of mining/gnuorder.py).  `verbose` reports
    on stderr which device holds which samples' tables.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    cfg.validate()
    if mesh is None:
        p, s = default_mesh_shape(len(jax.devices()))
        mesh = make_mesh(p, s)
    n_prefix = mesh.shape[PREFIX_AXIS]
    n_sshard = mesh.shape[SAMPLES_AXIS]
    d = len(indexes)
    pad_to = -(-d // n_sshard) * n_sshard
    dev = ShardedIndexes.build(
        indexes, pad_to=pad_to,
        sharding=NamedSharding(mesh, P(SAMPLES_AXIS)))

    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    deep = row_prefix_masks(n_prefix)          # (n_prefix, k_rows, 4)
    k_rows = deep.shape[1]
    trackers = None
    if reader_order == "gnu":
        from ..mining.gnuorder import GnuOrderTracker

        # one tracker per row = one reference server per owned prefix
        # set; the enforced-path depth is the longer of the row's hash
        # length and the user prefix (wrapper-SLURM/example-server.sh)
        trackers = [GnuOrderTracker(
            d, server_prefix_len=max(1, k_rows, len(prefix)))
            for _ in range(n_prefix)]
    elif reader_order != "ascending":
        raise ValueError(f"unknown reader_order {reader_order!r}")
    step = _jitted_sharded_step(mesh)
    fmin = jnp.asarray(cfg.fmin, dtype=jnp.int32)
    mask_all = jnp.asarray(np.repeat(np.ones((1, 4), bool), n_prefix, 0))
    mask_none = jnp.asarray(np.zeros((n_prefix, 4), bool))
    prefix_codes = [EXT_CHARS.index(b) for b in prefix]
    onehots = [jnp.asarray(np.repeat(np.eye(4, dtype=bool)[ci][None],
                                     n_prefix, 0)) for ci in range(4)]

    frows, rrows = dev.frows, dev.rrows
    if verbose:
        print(f"mine_sharded: table shards {dev.placement('f')}",
              file=sys.stderr, flush=True)
    state = _seed_sharded(dev, n_prefix, cap)
    paths: list[list[bytes]] = [[b""] for _ in range(n_prefix)]
    depth = 0

    while True:
        if depth >= cfg.maxdepth:
            sym_mask = mask_none
        else:
            # per-row deep prefix ownership (AA..TT partitions) composed
            # with the user's enforced path
            sym_mask = mask_all
            if depth < k_rows:
                sym_mask = sym_mask & jnp.asarray(deep[:, depth, :])
            if depth < len(prefix_codes):
                sym_mask = sym_mask & onehots[prefix_codes[depth]]

        res = step(frows, rrows, *state, fmin, sym_mask)
        counts = np.asarray(res["child_count"])
        cap_now = state[0].shape[1]
        if counts.max() > cap_now:
            state = _resize_sharded(state, _next_pow2(int(counts.max())))
            continue

        if depth > 0:
            freq = np.asarray(res["freq"]).astype(np.int64)[:, :, :d]
            lc = np.asarray(res["lc"])[:, :, :d]
            sf = np.asarray(res["single_full"])
            for r in range(n_prefix):
                emit_level(
                    out, cfg, d, depth,
                    paths[r] + [b""] * (cap_now - len(paths[r])),
                    freq[r], lc[r], sf[r],
                    trackers[r] if trackers else None,
                )
        if counts.max() == 0:
            break

        parent_row = np.asarray(res["parent_row"])
        sym = np.asarray(res["sym"])
        if trackers is not None:
            child_act = np.asarray(res["hi"] > res["lo"])[:, :, :d]
            for r in range(n_prefix):
                cc = int(counts[r])
                trackers[r].advance(
                    depth, paths[r],
                    [(int(u), int(c), child_act[r, j])
                     for j, (u, c) in enumerate(
                         zip(parent_row[r, :cc].tolist(),
                             sym[r, :cc].tolist()))],
                )
        for r in range(n_prefix):
            cc = int(counts[r])
            paths[r] = [paths[r][u] + EXT_CHARS[c:c + 1]
                        for u, c in zip(parent_row[r, :cc].tolist(),
                                        sym[r, :cc].tolist())]
        state = (res["lo"], res["hi"], res["rlo"], res["valid"])
        want = max(MIN_CAP, _next_pow2(int(counts.max())))
        if want < cap_now:
            state = _resize_sharded(state, want)
        depth += 1

    out.sort_postorder()
    return out
