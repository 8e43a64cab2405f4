"""Checks that need the GPU: the rank primitives, the suffix sort, the
mining episode, the distance path's matrix products and the memory
budget, each against its plain reference, compiled for the card.

Run on a machine with a GPU by `python chip_smoke.py` (its gpu-tests
phase: DSM_TEST_GPU=1 pytest -m gpu); elsewhere the `gpu_device`
fixture skips them.
"""

import glob
import os

import numpy as np
import pytest

from test_rank import RANK_FNS, check_rank

pytestmark = pytest.mark.gpu

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("fn", RANK_FNS)
def test_rank_gpu(gpu_device, fn):
    check_rank(fn, n=1 << 16, seed=3, baked=True)


def test_suffix_array_gpu(gpu_device):
    from dsm_tpu.ops.sa import suffix_array_jax, suffix_array_np

    codes = np.random.default_rng(4).integers(0, 7, size=50_000)
    np.testing.assert_array_equal(np.asarray(suffix_array_jax(codes)),
                                  suffix_array_np(codes))


def test_episode_matches_oracle_gpu(gpu_device):
    from dsm_tpu.index.alphabet import transform
    from dsm_tpu.index.fasta import read_fasta
    from dsm_tpu.index.fmindex import FMIndex
    from dsm_tpu.mining.config import MiningConfig
    from dsm_tpu.mining.engine_device import mine_device
    from dsm_tpu.mining.engine_np import mine_np

    idxs = [FMIndex.from_texts([transform(r.seq) for r in read_fasta(p)])
            for p in sorted(glob.glob(os.path.join(
                HERE, "data", "toydata", "toy*.fasta.gz")))]
    cfg = MiningConfig(fmin=2, emax=1.2, maxdepth=12)
    for order in ("ascending", "gnu"):
        got = mine_device(idxs, cfg, reader_order=order)
        want = mine_np(idxs, cfg, reader_order=order)
        assert got.format_lines() == want.format_lines()
        assert got.total_paths == want.total_paths


def test_distance_jax_gpu(gpu_device):
    from test_distance import test_jax_path_matches

    test_jax_path_matches()


def test_hbm_budget_gpu(gpu_device):
    from dsm_tpu.mining.engine import hbm_budget

    if os.environ.get("DSM_HBM_BYTES"):
        pytest.skip("DSM_HBM_BYTES overrides the device's report")
    lim = gpu_device.memory_stats()["bytes_limit"]
    assert hbm_budget() == int(lim * 0.9) > 0
