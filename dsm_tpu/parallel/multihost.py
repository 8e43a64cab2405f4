"""Multi-host mining (SURVEY.md §5.7/§5.8; reference topology:
README.md:22-24 — 29 nodes, 256 per-prefix servers, one client process
per sample, all wired over TCP by the SLURM wrappers).

Two composition modes, matching how the reference scales:

  * PREFIX OWNERSHIP (`owned_prefixes` + `mine_owned`) — each host mines
    its contiguous share of the 4**k length-k DNA prefixes with
    enforcepath episodes on its local devices, exactly one reference
    "server hash" per prefix (wrapper-SLURM/example-server.sh).  No
    cross-host traffic at all; concatenating the per-host outputs is the
    full mine (differentially tested in tests/test_multihost.py).

  * GLOBAL SAMPLES MESH (`global_samples_mesh` + engine_episode) — after
    `initialize()` (jax.distributed), a ('samples',) mesh over EVERY
    host's devices runs the device-resident episode loop with its
    per-level psums crossing the host's own interconnect within a host
    and the network across hosts.  The
    episode driver's host pulls are all-gathers, so every process sees
    identical drained outputs and emits the same lines.

`dsm mine --num-hosts N --host-id I [--coordinator H:P]` drives the
prefix-ownership mode from the CLI (cli/main.py); `dsm launch --mode
slurm` emits one-server-per-prefix sbatch scripts for the wire-protocol
fleet instead.
"""

from __future__ import annotations

import numpy as np

from ..index.fmindex import FMIndex
from ..mining.config import MiningConfig
from ..mining.engine_np import MinedOutput
from .mesh import SAMPLES_AXIS, prefix_depth, prefixes_of_row


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """jax.distributed.initialize wrapper (idempotent per process)."""
    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_samples_mesh():
    """('samples',) mesh over every process's devices."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    return Mesh(np.array(devs).reshape(len(devs)), (SAMPLES_AXIS,))


def owned_prefixes(num_hosts: int, host_id: int,
                   hash_depth: int | None = None) -> list[bytes]:
    """The DNA prefixes host `host_id` of `num_hosts` owns: a contiguous
    partition of the 4**hash_depth length-hash_depth prefixes
    (hash_depth defaults to the smallest depth with enough prefixes)."""
    if not 0 <= host_id < num_hosts:
        raise ValueError("host_id out of range")
    if hash_depth is None:
        hash_depth = max(1, prefix_depth(num_hosts))
    n = 4 ** hash_depth
    if num_hosts > n:
        raise ValueError(f"more hosts than 4**{hash_depth} prefixes")
    # contiguous split of the prefix index range (uneven tails allowed)
    lo = host_id * n // num_hosts
    hi = (host_id + 1) * n // num_hosts
    bases = b"ACGT"
    out = []
    for i in range(lo, hi):
        digs = [(i // 4 ** (hash_depth - 1 - d)) % 4
                for d in range(hash_depth)]
        out.append(bytes(bases[x] for x in digs))
    return out


def merge_outputs(parts: list[MinedOutput], d: int) -> MinedOutput:
    """Combine disjoint-subtree mining outputs (counters summed, lines
    re-sorted into global lexicographic post-order)."""
    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    out.smallest_entropy = 1000.0
    out.largest_entropy = -1000.0
    for p in parts:
        out.lines.extend(p.lines)
        out.total_paths += p.total_paths
        out.total_output += p.total_output
        out.total_occs += p.total_occs
        out.smallest_entropy = min(out.smallest_entropy, p.smallest_entropy)
        out.largest_entropy = max(out.largest_entropy, p.largest_entropy)
        if p.freq_histogram is not None:
            out.freq_histogram += np.asarray(p.freq_histogram)
    out.sort_postorder()
    return out


def mine_owned(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    num_hosts: int,
    host_id: int,
    hash_depth: int | None = None,
    engine: str = "tpu",
) -> MinedOutput:
    """Mine this host's owned prefix shards on its local devices and
    merge.  Together with the other hosts' runs this is the complete
    mine — the reference's multi-node production layout with episodes
    instead of TCP servers."""
    d = len(indexes)
    parts = []
    for prefix in owned_prefixes(num_hosts, host_id, hash_depth):
        if engine == "numpy":
            from ..mining.engine_np import mine_np

            parts.append(mine_np(indexes, cfg, prefix=prefix))
        else:
            from ..mining.engine import mine_tpu

            parts.append(mine_tpu(indexes, cfg, prefix=prefix))
    return merge_outputs(parts, d)
