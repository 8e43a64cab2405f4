"""Device-mesh construction for the mining wavefront.

The reference scales along two axes (SURVEY.md §2.5):
  * samples — one metaenumerate process per sample, merged by a server
    over d TCP streams (metaserver.cpp:682-728);
  * trie prefixes — one metaserver per DNA-prefix shard, clients descend
    each server's enforcepath (wrapper-SLURM/example-server.sh,
    EnumerateQuery.cpp:240-290).

Here both become mesh axes: ('prefix', 'samples').  The samples axis
shards the per-sample occ tables and frequency columns — the TCP merge
becomes psums over that axis.  The prefix axis shards disjoint depth-0
symbol partitions of the union trie — embarrassingly parallel, no
collectives, exactly like the reference's per-prefix server processes.
"""

from __future__ import annotations

import numpy as np

PREFIX_AXIS = "prefix"
SAMPLES_AXIS = "samples"


def make_mesh(n_prefix: int, n_samples: int, devices=None):
    import jax

    if devices is None:
        devices = jax.devices()
    need = n_prefix * n_samples
    if len(devices) < need:
        raise ValueError(
            f"mesh {n_prefix}x{n_samples} needs {need} devices, "
            f"have {len(devices)}")
    arr = np.array(devices[:need]).reshape(n_prefix, n_samples)
    return jax.sharding.Mesh(arr, (PREFIX_AXIS, SAMPLES_AXIS))


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor a device count into (prefix, samples) axes: prefer 4 prefix
    shards (the reference's production A/C/G/T partitioning), else 2."""
    for p in (4, 2, 1):
        if n_devices % p == 0:
            return p, n_devices // p
    return 1, n_devices


def row_masks(n_prefix: int) -> np.ndarray:
    """(n_prefix, 4) bool: which depth-0 child symbols each prefix row
    owns.  Rows partition {A,C,G,T} contiguously.  For deeper partitions
    (AA..TT and beyond, the reference's 16/64-server hash arrays in
    wrapper-SLURM/example-server.sh) use row_prefix_masks."""
    if n_prefix > 4:
        raise ValueError("use row_prefix_masks for >4 prefix rows")
    if 4 % n_prefix:
        raise ValueError("prefix axis must divide 4")
    masks = np.zeros((n_prefix, 4), dtype=bool)
    per = 4 // n_prefix
    for r in range(n_prefix):
        masks[r, r * per:(r + 1) * per] = True
    return masks


def prefix_depth(n_prefix: int) -> int:
    """Smallest k with 4**k >= n_prefix (enforced-prefix length)."""
    k = 0
    while 4 ** k < n_prefix:
        k += 1
    return k


def _depth_splits(n_prefix: int) -> list[list[list[int]]]:
    """Factor n_prefix into per-depth contiguous symbol-group splits
    (each depth splits {A,C,G,T} into <= 4 groups; the row count is the
    product of group counts).  Any n whose prime factors are <= 4 (2s
    and 3s) is expressible; sizes are balanced as evenly as 4 symbols
    allow (4 -> 1+1+1+1, 3 -> 1+1+2, 2 -> 2+2)."""
    groups_of = {
        1: [[0, 1, 2, 3]],
        2: [[0, 1], [2, 3]],
        3: [[0], [1], [2, 3]],
        4: [[0], [1], [2], [3]],
    }
    n = n_prefix
    splits: list[list[list[int]]] = []
    while n > 1:
        for f in (4, 2, 3):
            if n % f == 0:
                splits.append(groups_of[f])
                n //= f
                break
        else:
            raise ValueError(
                f"{n_prefix} prefix rows: a per-depth symbol-mask "
                "partition exists only for row counts whose prime "
                "factors are <= 4; for other counts give each worker an "
                "explicit prefix list (parallel/multihost.owned_prefixes "
                "+ per-prefix episodes, the reference's hash-array "
                "topology)")
    return splits or [groups_of[1]]


def row_prefix_masks(n_prefix: int) -> np.ndarray:
    """(n_prefix, k, 4) bool per-depth symbol masks implementing an
    AA..TT-style partition of the length-k DNA prefixes into n_prefix
    rows (k = number of split depths).

    Each depth d splits the symbol alphabet into contiguous groups and
    a row owns one group per depth — so ownership is path-independent
    per depth, exactly the per-depth mask form the mining engines
    consume (mirroring the reference's one-enforcepath-per-server
    topology, metaenumerate.cpp:268-309; wrapper-SLURM 16/64-server
    hash arrays).  Works for ANY row count whose prime factors are
    <= 4 (2, 3, 4, 6, 8, 12, 16, ...); counts with a 3-way depth split
    carry a mild load imbalance (one group owns two symbols).  For
    other counts (5, 7, ...) use owned_prefixes' explicit lists."""
    splits = _depth_splits(n_prefix)
    if n_prefix == 1:
        return np.ones((1, 0, 4), dtype=bool)
    k = len(splits)
    masks = np.zeros((n_prefix, k, 4), dtype=bool)
    for r in range(n_prefix):
        rr = r
        for d in range(k - 1, -1, -1):
            groups = splits[d]
            g = rr % len(groups)
            rr //= len(groups)
            masks[r, d, groups[g]] = True
    return masks


def prefixes_of_row(n_prefix: int, row: int) -> list[bytes]:
    """The length-k DNA prefixes row `row` owns (cartesian product of
    its per-depth symbol groups, matching row_prefix_masks)."""
    from itertools import product

    masks = row_prefix_masks(n_prefix)
    k = masks.shape[1]
    bases = b"ACGT"
    opts = [[i for i in range(4) if masks[row, d, i]] for d in range(k)]
    return [bytes(bases[x] for x in digs) for digs in product(*opts)]
