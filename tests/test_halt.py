"""Halt/steering side channel (VERDICT r4 missing #3).

The reference carries a vestigial server->client "stop this branch"
back-channel (ServerSocket::writeHalt ServerSocket.h:88-95,
TrieReader::sendHalt TrieReader.h:156-159, ClientSocket::checkHalt
ClientSocket.h:48-77; client hooks commented out,
EnumerateQuery.cpp:111-119).  Our device form is a frontier pruning mask
applied at episode exits (engine_device._apply_halt): `mine_device`
polls `halt(depth, out)` and stops exploring below any returned path
prefix from the next level on."""

from __future__ import annotations

import numpy as np
import pytest

from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine_device import mine_device
from dsm_tpu.mining.engine_np import mine_np


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(0xA117)
    idxs = []
    for s in range(3):
        texts = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                  int(rng.integers(400, 900))))
                 for _ in range(3)]
        idxs.append(FMIndex.from_texts(
            [np.frombuffer(t, np.uint8) for t in texts]))
    return idxs


def _path(line: bytes) -> bytes:
    return line.split(b" ", 1)[0]


def test_halt_prunes_subtree(indexes):
    cfg = MiningConfig(fmin=2, emax=1.9)
    oracle = mine_np(indexes, cfg)
    applied = []

    def halt(depth, out):
        applied.append(depth)
        return [b"A"]

    # a tiny out_reserve forces frequent drain exits, so the halt is
    # polled early and often
    got = mine_device(indexes, cfg, out_reserve=1, halt=halt)
    assert applied, "halt was never polled"
    h = applied[0]
    got_lines = got.format_lines().splitlines(keepends=True)
    want_lines = oracle.format_lines().splitlines(keepends=True)
    got_set = set(got_lines)
    # 1. pruning only removes lines, never invents or alters them
    assert got_set <= set(want_lines)
    # 2. nothing under the halted prefix deeper than the first
    #    application survives
    for ln in got_lines:
        p = _path(ln)
        assert not (p.startswith(b"A") and len(p) > h), (ln, h)
    # 3. everything OUTSIDE the halted subtree is untouched
    want_rest = [ln for ln in want_lines if not _path(ln).startswith(b"A")]
    got_rest = [ln for ln in got_lines if not _path(ln).startswith(b"A")]
    assert got_rest == want_rest


def test_halt_none_is_identity(indexes):
    cfg = MiningConfig(fmin=2, emax=1.9)
    a = mine_device(indexes, cfg, out_reserve=1, halt=lambda d, o: [])
    b = mine_np(indexes, cfg)
    assert a.format_lines() == b.format_lines()
