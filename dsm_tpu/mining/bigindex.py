"""Capacity planning and the bounded-HBM mining path.

The reference mines arbitrarily large samples with tiny-memory servers
streaming from run-length-compressed indexes (rlcsa.h:40-50,
metaserver.cpp:488-815).  The device episode engine wants its tables
resident, so the big-collection story here is explicit:

  1. SIZING MATH (`table_bytes` / `episode_bytes` / `plan`): the
     resident cost of a collection is ~2 B per indexed symbol (one
     fused 128-byte row per 128-symbol block, both orientations) plus
     episode buffers, planned against the device's own memory limit
     (engine.hbm_budget); independent of memory, the episode's
     (soff, sid) int32 sort-operand packing caps one device at ~537 M
     symbols (engine.MAX_TABLE_ROWS, checked with a clear error).
  2. SAMPLE SHARDING is the production scale-out: shard the sample
     axis over a mesh (parallel/engine_episode.py) so each device holds
     only its samples' tables — `plan` reports the device count.
  3. HOST-RESIDENT FALLBACK (`mine_big`): when the collection exceeds
     the accelerator budget and no more devices are available, mine
     with the per-level host wavefront (engine_np) whose occ structure
     is the sampled-block layout in host RAM (~1.3 B/symbol) — bounded
     memory at any size, like the reference's own CPU path, and still
     byte-identical output.

A note on why there is no per-prefix table slicing: an enforced trie
prefix fixes the OLDEST characters of the path, but backward search
prepends, so the ranked (forward-index) interval of a node lies in the
range of its NEWEST character — only the synced reverse-side interval
is contained under the prefix.  Prefix partitioning therefore shards
WORK (parallel/mesh.py, multihost.py) but cannot shrink the ranked
table's resident set; residency scales down only with the sample axis.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..index.fmindex import FMIndex
from ..ops.rank import BLOCK, ROWW
from .config import MiningConfig
from .engine import MAX_TABLE_ROWS, hbm_budget
from .engine_np import MinedOutput
from .engine_device import CAP_MAX, _hist_cap, _next_pow2

def table_rows(indexes) -> int:
    return sum(idx.n // BLOCK + 2 for idx in indexes)


def table_bytes(indexes) -> int:
    """Device bytes for the resident tables (both orientations)."""
    return 2 * table_rows(indexes) * ROWW * 4


def episode_bytes(indexes) -> int:
    """Device bytes for the episode state buffers at auto sizing
    (engine_device._auto_cap/_hist_cap/_seed_episode arithmetic)."""
    n = sum(idx.n for idx in indexes)
    cap = min(max(_next_pow2(n + 1) // 4, 1 << 13), CAP_MAX)

    class _N:
        ns = np.array([n])
    hist = _hist_cap(_N) + cap
    # pr [2, 2*cap, 8] i32, hist i32, nb/out/lvl_off small
    return 2 * 2 * cap * 8 * 4 + 4 * hist + 2 * cap * 4


@dataclass
class CapacityPlan:
    """Where a collection fits.  mode is 'device' (single-device episode),
    'shard' (sample-shard over `devices` devices), or 'host' (host
    wavefront fallback)."""

    mode: str
    devices: int
    resident_bytes: int
    budget: int
    reason: str


def plan(indexes, budget: int | None = None,
         devices_available: int | None = None) -> CapacityPlan:
    budget = hbm_budget() if budget is None else budget
    eb = episode_bytes(indexes)
    tb = table_bytes(indexes)
    rows = table_rows(indexes)
    if rows < MAX_TABLE_ROWS and tb + eb <= budget:
        return CapacityPlan("device", 1, tb + eb, budget,
                            "full residency fits one device")
    # sample-shard: the largest per-shard table must fit; approximate
    # with a balanced split over the sample axis
    if devices_available is None:
        try:
            import jax

            devices_available = len(jax.devices())
        except Exception:
            devices_available = 1
    per = sorted((idx.n // BLOCK + 2 for idx in indexes), reverse=True)
    for ndev in range(2, devices_available + 1):
        # greedy largest-first bin packing over ndev devices
        bins = [0] * ndev
        for r in per:
            bins[int(np.argmin(bins))] += r
        worst = max(bins)
        if worst < MAX_TABLE_ROWS and 2 * worst * ROWW * 4 + eb <= budget:
            return CapacityPlan(
                "shard", ndev, 2 * worst * ROWW * 4 + eb, budget,
                f"sample axis sharded over {ndev} devices "
                "(parallel/engine_episode.mine_device_sharded)")
    return CapacityPlan(
        "host", 0, 0, budget,
        f"tables need {tb + eb:,} bytes resident (packing bound "
        f"{MAX_TABLE_ROWS} rows, budget {budget:,}) and "
        f"{devices_available} device(s) cannot shard it; host-resident "
        "wavefront engine (bounded memory, reference-style CPU path)")


def mine_big(indexes, cfg: MiningConfig,
             budget: int | None = None,
             devices_available: int | None = None,
             reader_order: str = "ascending",
             verbose: bool = False) -> MinedOutput:
    """Mine under an explicit HBM budget: single-device episode when it
    fits, sample-sharded episode when a mesh can hold it, host
    wavefront otherwise — never an opaque OOM."""
    p = plan(indexes, budget, devices_available)
    if verbose:
        print(f"mine_big: {p.mode} — {p.reason} "
              f"(resident {p.resident_bytes:,} / budget {p.budget:,})",
              file=sys.stderr, flush=True)
    if p.mode == "device":
        from .engine_device import mine_device

        return mine_device(indexes, cfg, reader_order=reader_order)
    if p.mode == "shard":
        from ..parallel.engine_episode import mine_device_sharded

        return mine_device_sharded(indexes, cfg,
                                   reader_order=reader_order,
                                   verbose=verbose)
    from .engine_np import mine_np

    return mine_np(indexes, cfg, reader_order=reader_order)
