"""Differential tests: the device wavefront engine vs the NumPy oracle.

The oracle (engine_np) is itself byte-parity-tested against the compiled
reference binaries (test_parity.py), so exact agreement here chains to
reference parity.  Runs on the CPU backend (tests/conftest.py); the same
jitted step is what chip_smoke.py runs on the GPU.

The toydata configs are depth-capped to keep CPU cost down (the machine
running unit tests has 2 cores); full-depth deep-chain behaviour (unary
chains, frontier shrink, termination) is covered on a smaller synthetic
set mined to exhaustion.
"""

import glob
import os

import numpy as np
import pytest

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fasta import read_fasta
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine import DeviceIndexes, mine_tpu
from dsm_tpu.mining.engine_np import mine_np

HERE = os.path.dirname(os.path.abspath(__file__))
TOYDATA = os.path.join(HERE, "data", "toydata")

CONFIGS = {
    "default": MiningConfig(fmin=2, emax=1.2, maxdepth=10),
    "specific": MiningConfig(fmin=5, emax=10, pmin=1, pmax=1, maxdepth=10),
    "filtered": MiningConfig(fmin=2, emax=1.5, emin=0.4, pmin=2, pmax=4,
                             mindepth=8, maxdepth=11),
    "deep1": MiningConfig(fmin=7, emax=99, pmin=1, maxdepth=12),
}


@pytest.fixture(scope="module")
def indexes():
    idxs = []
    for path in sorted(glob.glob(os.path.join(TOYDATA, "toy*.fasta.gz"))):
        texts, names = [], []
        for rec in read_fasta(path):
            texts.append(transform(rec.seq))
            names.append(rec.name)
        idxs.append(FMIndex.from_texts(texts, names))
    return idxs


@pytest.fixture(scope="module")
def dev(indexes):
    return DeviceIndexes.build(indexes)


@pytest.fixture(scope="module")
def small_indexes(rng):
    """3 samples sharing fragments of a 500bp genome + private junk;
    small enough to mine to full depth on CPU."""
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=500)]
    idxs = []
    for s in range(3):
        texts = []
        for r in range(12):
            start = int(rng.integers(0, 420))
            texts.append(transform(genome[start:start + 80].tobytes()))
        texts.append(transform(
            np.frombuffer(b"ACGT", dtype=np.uint8)[
                rng.integers(0, 4, size=200)].tobytes()))
        idxs.append(FMIndex.from_texts(texts))
    return idxs


@pytest.mark.parametrize("config", list(CONFIGS))
def test_engine_matches_oracle(indexes, dev, config):
    cfg = CONFIGS[config]
    want = mine_np(indexes, cfg)
    got = mine_tpu(indexes, cfg, dev=dev)
    assert got.format_lines() == want.format_lines()
    assert got.total_output == want.total_output
    assert np.array_equal(got.freq_histogram, want.freq_histogram)


def test_engine_enforced_prefix(indexes, dev):
    cfg = MiningConfig(fmin=2, emax=1.2, maxdepth=10)
    for prefix in (b"A", b"GA"):
        want = mine_np(indexes, cfg, prefix=prefix)
        got = mine_tpu(indexes, cfg, prefix=prefix, dev=dev)
        assert got.format_lines() == want.format_lines()


def test_engine_tail_handoff_equivalence(small_indexes):
    """Pure-device episodes (tail_width=0) and immediate host handoff
    (tail_width huge) must produce identical output to the oracle —
    the hybrid split point is invisible in the result."""
    from dsm_tpu.mining.engine_device import mine_device

    cfg = MiningConfig(fmin=2, emax=99)
    want = mine_np(small_indexes, cfg)
    for tw in (0, 1 << 20):
        got = mine_device(small_indexes, cfg, tail_width=tw)
        assert got.format_lines() == want.format_lines(), f"tail_width={tw}"
        assert got.total_paths == want.total_paths


def test_engine_full_depth_small(small_indexes):
    """Unbounded depth: exercises unary chains, frontier shrink/overflow
    regrow, and loop termination against the oracle."""
    for cfg in (MiningConfig(fmin=2, emax=99),
                MiningConfig(fmin=1, emax=99, pmin=1)):
        want = mine_np(small_indexes, cfg)
        got = mine_tpu(small_indexes, cfg, cap=256)
        assert got.format_lines() == want.format_lines()
        assert got.total_paths == want.total_paths
        assert got.total_occs == want.total_occs
        # entropy-range *diagnostics* are tracked in f32 on device
        # (engine_device module doc); output lines above are exact f64
        assert abs(got.smallest_entropy - want.smallest_entropy) < 5e-6
        assert abs(got.largest_entropy - want.largest_entropy) < 5e-6


@pytest.fixture(scope="module")
def many_sample_indexes(rng):
    """64 tiny samples sharing a genome pool — proves the sparse pair
    layout scales the sample axis (VERDICT r2 #9; the reference caps at
    MAX_READERS=273, metaserver.cpp:19)."""
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=400)]
    idxs = []
    for s in range(64):
        texts = [transform(
            genome[int(rng.integers(0, 340)):][:60].tobytes())
            for _ in range(3)]
        idxs.append(FMIndex.from_texts(texts))
    return idxs


def test_engine_many_samples(many_sample_indexes):
    """Full-depth 64-sample mining on the episode engine vs the oracle;
    memory stays O(pairs), not O(nodes x samples)."""
    from dsm_tpu.mining.engine_device import mine_device

    cfg = MiningConfig(fmin=2, emax=99)
    want = mine_np(many_sample_indexes, cfg)
    got = mine_device(many_sample_indexes, cfg)
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths
    assert np.array_equal(got.freq_histogram, want.freq_histogram)


def test_engine_273_samples_reachable(rng):
    """MAX_READERS-scale sample count (273, metaserver.cpp:19) runs end
    to end on the episode engine (shallow config keeps CPU cost low)."""
    from dsm_tpu.mining.engine_device import mine_device

    base = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=120)]
    idxs = []
    for s in range(273):
        start = int(rng.integers(0, 80))
        idxs.append(FMIndex.from_texts([transform(
            base[start:start + 40].tobytes())]))
    cfg = MiningConfig(fmin=2, emax=99, maxdepth=6)
    want = mine_np(idxs, cfg)
    got = mine_device(idxs, cfg)
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths


def test_stable_hv_fallback_matches(small_indexes, monkeypatch):
    """The children-sort keys on hv alone + is_stable when
    (bucket x P2) overflows uint32 (engine_device._use_poff_key);
    equal-hv lanes sit in c-major order = ascending pair order, so the
    two key schemes must mine identically."""
    import dsm_tpu.mining.engine_device as ed
    from dsm_tpu.mining.config import MiningConfig
    from dsm_tpu.mining.engine_device import mine_device

    cfg = MiningConfig(fmin=2, emax=1.6)
    want = mine_device(small_indexes, cfg)
    monkeypatch.setattr(ed, "_use_poff_key", lambda B, P2: False)
    ed._jitted_episode.cache_clear()
    try:
        got = mine_device(small_indexes, cfg)
    finally:
        ed._jitted_episode.cache_clear()
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths
