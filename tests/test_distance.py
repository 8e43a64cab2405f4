"""Distance-matrix post-processing vs the reference smtxt2entropy.

Differential: feed the same mined rows (golden metaserver output) to the
compiled reference binary (wrapper-distance-matrix/smtxt2entropy.c) and
to dsm_tpu.post.distance, diff the four output files byte-wise.  The
binary is compiled on demand into $DSM_REF_BIN (conftest.py; else the
checkout's .cache/refsrc); tests skip if no toolchain.  Batched (exact=False) and jax paths are checked against the
exact path numerically.
"""

import glob
import gzip
import os
import subprocess

import numpy as np
import pytest

from dsm_tpu.post.distance import (
    DistanceAccumulator,
    entropy_steps,
    pairwise_matrices,
    pairwise_matrices_jax,
    parse_row,
    row_entropy,
)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
REF_BIN = os.environ.get("DSM_REF_BIN") or os.path.join(
    os.path.dirname(HERE), ".cache", "refsrc")
SMTXT = os.path.join(REF_BIN, "smtxt2entropy")
SRC = "/root/reference/wrapper-distance-matrix/smtxt2entropy.c"


def ensure_binary():
    if os.path.exists(SMTXT):
        return True
    try:
        os.makedirs(REF_BIN, exist_ok=True)
        subprocess.run(["gcc", "-O2", "-o", SMTXT, SRC, "-lm"], check=True,
                       capture_output=True)
        return True
    except Exception:
        return False


def golden_rows(config: str) -> bytes:
    chunks = []
    for prefix in "ACGT":
        with gzip.open(os.path.join(
                GOLDEN, f"server-output.{config}.{prefix}.txt.gz")) as f:
            chunks.append(f.read())
    return b"".join(chunks)


@pytest.mark.parametrize("config,args", [
    ("wide", {"maxents": [0.3, 0.6, 1.0]}),
    ("wide", {"maxents": [1.0], "minfreq": 4}),
    ("specific", {"maxents": entropy_steps(0.25)}),
    ("default", {"maxents": [0.5, 1.0],
                 "runtosmpl": np.array([0, 1, 1, 2, 0])}),
])
def test_vs_reference_binary(tmp_path, config, args):
    if not ensure_binary():
        pytest.skip("no toolchain for reference smtxt2entropy")
    rows = golden_rows(config)

    cmd = [SMTXT, "-F", "out",
           "-m", ",".join(str(m) for m in args["maxents"])]
    smpls = 5
    if "runtosmpl" in args:
        rts = args["runtosmpl"]
        sfile = tmp_path / "samples.txt"
        sfile.write_text("".join(f"{v}\n" for v in rts))
        cmd += ["-S", str(sfile)]
        smpls = int(rts.max()) + 1
    else:
        cmd += ["-s", "5"]
    if "minfreq" in args:
        cmd += ["-M", str(args["minfreq"])]
    subprocess.run(cmd, input=rows, cwd=tmp_path, check=True,
                   capture_output=True)

    acc = DistanceAccumulator(smpls=smpls, runs=5,
                              maxents=args["maxents"],
                              runtosmpl=args.get("runtosmpl"),
                              minfreq=args.get("minfreq", 0))
    acc.add_lines(rows.decode().splitlines())
    ours = tmp_path / "ours"
    ours.mkdir()
    acc.write("out", str(ours))

    for kind in ("count", "log", "sqrt", "lgamma"):
        ref = (tmp_path / f"{kind}.out").read_text()
        got = (ours / f"{kind}.out").read_text()
        if got != ref:
            # float-string parity can differ by 1 ulp of libm; compare
            # numerically at printf("%f") resolution before failing
            for lr, lg in zip(ref.splitlines(), got.splitlines()):
                if lr == lg:
                    continue
                assert lr.split()[0] == "Matrix" or all(
                    abs(float(a) - float(b)) < 1e-5
                    for a, b in zip(lr.split(), lg.split())
                ), f"{config} {kind}: {lg!r} != {lr!r}"


def test_normalized_vs_reference_binary(tmp_path):
    if not ensure_binary():
        pytest.skip("no toolchain for reference smtxt2entropy")
    rows = golden_rows("wide")
    sizes = [1000.0, 2000.0, 1500.0, 800.0, 3000.0]
    nfile = tmp_path / "sizes.txt"
    nfile.write_text("".join(f"toy{i}\t{s}\n" for i, s in enumerate(sizes)))
    subprocess.run(
        [SMTXT, "-s", "5", "-m", "0.5,1.0", "-F", "out", "-N", str(nfile)],
        input=rows, cwd=tmp_path, check=True, capture_output=True)

    acc = DistanceAccumulator(smpls=5, maxents=[0.5, 1.0],
                              sizes=np.array(sizes))
    acc.add_lines(rows.decode().splitlines())
    ours = tmp_path / "ours"
    ours.mkdir()
    acc.write("out", str(ours))
    for kind in ("count", "log", "sqrt", "lgamma"):
        ref = (tmp_path / f"{kind}.out").read_text()
        got = (ours / f"{kind}.out").read_text()
        for lr, lg in zip(ref.splitlines(), got.splitlines()):
            if lr == lg:
                continue
            assert all(abs(float(a) - float(b)) < 1e-5
                       for a, b in zip(lr.split(), lg.split())), \
                f"norm {kind}: {lg!r} != {lr!r}"


def test_batched_matches_exact():
    rows = golden_rows("wide").decode().splitlines()
    kw = dict(smpls=5, maxents=[0.4, 0.8, 1.0])
    a = DistanceAccumulator(exact=True, **kw)
    b = DistanceAccumulator(exact=False, chunk_rows=64, **kw)
    a.add_lines(rows)
    b.add_lines(rows)
    ra, rb = a.matrices(), b.matrices()
    assert np.array_equal(ra["count"], rb["count"])
    assert np.array_equal(ra["noutput"], rb["noutput"])
    for kind in ("log", "sqrt", "lgamma"):
        np.testing.assert_allclose(ra[kind], rb[kind], rtol=1e-9, atol=1e-9)


def test_jax_path_matches():
    rows = golden_rows("default").decode().splitlines()
    F = np.stack([parse_row(r, 5) for r in rows])
    ent = np.array([row_entropy(f, 5) for f in F])
    thresholds = np.array([1.0, 0.5])  # descending, as the accumulator holds
    bins = np.where(ent <= 0.5, 1, 0)
    ref = pairwise_matrices(F, 2, bins)
    got = pairwise_matrices_jax(F, 2, bins)
    assert np.array_equal(np.asarray(got["count"]), ref["count"])
    # the jax path accumulates in float32 (products at HIGHEST precision,
    # so no TF32 rounding on a GPU): relative rounding of ~1e-7 per term
    # over the golden set's rows, plus the cancellation in
    # s2_j + s2_k - 2*cross of sqdiff, stays well under 2e-4
    for kind in ("log", "sqrt", "lgamma"):
        np.testing.assert_allclose(np.asarray(got[kind]), ref[kind],
                                   rtol=2e-4, atol=2e-4)


def test_entropy_steps():
    assert entropy_steps(0.25) == [0.0, 0.25, 0.5, 0.75, 1.0]
    steps = entropy_steps(0.3)
    assert steps[0] == 0.0 and steps[-1] == 1.0
