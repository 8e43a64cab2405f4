"""Smoke test of the whole pipeline on the GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sample-sharded engines on four

Run from the repository root on a machine with an NVIDIA GPU.  One card:

  gpu-tests  `pytest -m gpu` in a child process, before this process
             imports JAX;
  oracle     `dsm build` + `dsm mine` at scale 10 (fresh seed) for four
             filter configurations in both reader orders, each output
             byte-equal to the NumPy oracle (mining/engine_np.py) on the
             same indexes;
  main       scale 100 at the frozen seed: `dsm build` (which must pick
             the device suffix sort), `dsm mine -f 2 -E 1.2 --reader-order
             gnu` cold and warm, whose bytes must hash to the reference
             servers' digest (tests/golden/scale100_gnu.json), then
             `dsm distance` on that output;
  large      scale 1000: `dsm mine --prefix` for A, C, G and T (the
             reference's four-server topology), and two three-symbol
             prefixes byte-equal to the oracle.

--four-cards runs only the multi-card path and what it is compared with:
`dsm mine --engine sharded-episode` at scale 100 against the digest, and
`--engine sharded` at scale 10 against the oracle, each reporting which
device holds which samples' tables.

Everything runs in this one process, which owns the card(s): the `dsm`
subcommands run in-process through dsm_tpu.cli.main.main with their
output sent to files under _work/smoke/.  The oracle runs in spawned
worker processes that never import JAX, beside the device work.  Each
phase prints one line with its checks, wall times and the process's
peak device memory so far, next to the card's name and power limit.  The last line is a
JSON object, printed only when every phase passed; without a GPU the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "_work", "smoke")
GOLDEN = os.path.join(HERE, "tests", "golden")
FRESH_SEED = 0xBEEF01

# tests/test_engine_tpu.py's configurations without their depth caps;
# "default" is also the production setting (-f 2 -E 1.2).  Each entry:
# dsm mine flags, and the MiningConfig keywords they must mean.
CONFIGS = {
    "default": (["-f", "2", "-E", "1.2"], dict(fmin=2, emax=1.2)),
    "specific": (["-f", "5", "-E", "10", "-P", "1", "--pmax", "1"],
                 dict(fmin=5, emax=10, pmin=1, pmax=1)),
    "filtered": (["-f", "2", "-E", "1.5", "-e", "0.4", "-P", "2",
                  "--pmax", "4", "-m", "8"],
                 dict(fmin=2, emax=1.5, emin=0.4, pmin=2, pmax=4,
                      mindepth=8)),
    "deep1": (["-f", "7", "-E", "99", "-P", "1"],
              dict(fmin=7, emax=99, pmin=1)),
}
PRODUCTION = CONFIGS["default"]


class SmokeFailure(Exception):
    """A check of the smoke test failed."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _cli(argv: list[str], out_path: str | None = None,
         in_path: str | None = None) -> tuple[float, str]:
    """Run one `dsm` subcommand in this process with stdout sent to
    `out_path` (and stdin read from `in_path`); -> (wall s, stderr)."""
    from dsm_tpu.cli.main import main as dsm

    err = io.StringIO()
    saved = sys.stdout, sys.stderr, sys.stdin
    with open(out_path or os.devnull, "wb") as fo, \
            open(in_path or os.devnull, "rb") as fi:
        out = io.TextIOWrapper(fo, write_through=True)
        inp = io.TextIOWrapper(fi)
        try:
            sys.stdout, sys.stderr, sys.stdin = out, err, inp
            t0 = time.perf_counter()
            rc = dsm(argv)
            out.flush()
            wall = time.perf_counter() - t0
        finally:
            sys.stdout, sys.stderr, sys.stdin = saved
            out.detach()
            inp.detach()
    check(rc == 0, f"dsm {argv[0]} exited {rc}: {err.getvalue()[-400:]}")
    return wall, err.getvalue()


def _paths_from(stderr: str) -> int:
    m = re.search(r"^Number of paths: (\d+)$", stderr, re.M)
    check(m is not None, "dsm mine -v printed no path count")
    return int(m.group(1))


def _oracle(index_paths: list[str], cfg_kw: dict, prefix: str,
            reader_order: str) -> tuple[bytes, int]:
    """mine_np on the .dsmi files `dsm build` wrote (worker process: no
    JAX here)."""
    from dsm_tpu.index.fmindex import FMIndex
    from dsm_tpu.mining.config import MiningConfig
    from dsm_tpu.mining.engine_np import mine_np

    idxs = [FMIndex.load(p) for p in index_paths]
    out = mine_np(idxs, MiningConfig(**cfg_kw), prefix=prefix.encode(),
                  reader_order=reader_order)
    return out.format_lines(), out.total_paths


def _pool(n: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(
        max_workers=max(1, min(n, (os.cpu_count() or 2) // 2)),
        mp_context=multiprocessing.get_context("spawn"))


def toydata():
    """tests/make_toydata.py, loaded by path (an installed package named
    `tests` may shadow the repository's); bench.py uses it too."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_toydata", os.path.join(HERE, "tests", "make_toydata.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dataset(name: str, scale: int, seed: int) -> tuple[list[str], float]:
    """Fresh FASTA samples under _work/smoke/<name>; -> (paths, gen s)."""
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    fastas = toydata().make_toydata(d, scale=scale, seed=seed)
    return fastas, time.perf_counter() - t0


def _build(fastas: list[str],
           expect_sa: str | None) -> tuple[list[str], float]:
    wall, err = _cli(["build", "-v", *fastas])
    if expect_sa is not None:
        check(f"sa-backend auto -> {expect_sa}" in err,
              f"dsm build did not choose the {expect_sa} suffix sort")
    return [f + ".dsmi" for f in fastas], wall


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def golden_scale100_gnu() -> tuple[str, int]:
    with open(os.path.join(GOLDEN, "scale100_gnu.json")) as f:
        g = json.load(f)
    return g["lines_sha256"], g["total_paths"]


# ------------------------------------------------------------ phases --

def phase_gpu_tests() -> dict:
    """`pytest -m gpu` in a child process that sees the card; every
    selected test must run and pass (a skip means no GPU)."""
    os.makedirs(WORK, exist_ok=True)
    xml = os.path.join(WORK, "gpu_tests.xml")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", f"--junitxml={xml}"],
        cwd=HERE, env=dict(os.environ, DSM_TEST_GPU="1"),
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(os.path.exists(xml), f"pytest wrote no report: {p.stdout[-400:]}")
    suite = ET.parse(xml).getroot()
    if suite.tag == "testsuites":
        suite = suite[0]
    n = {k: int(suite.get(k, 0))
         for k in ("tests", "failures", "errors", "skipped")}
    check(p.returncode == 0 and n["tests"] > 0 and n["failures"] == 0
          and n["errors"] == 0 and n["skipped"] == 0,
          f"gpu tests {n}, rc {p.returncode}: {p.stdout[-800:]}")
    return {"checks": {"gpu_tests_passed": n["tests"]},
            "times_s": {"pytest": wall}}


def phase_oracle(scale: int = 10, seed: int = FRESH_SEED,
                 configs: dict = CONFIGS, expect_sa: str | None = "jax"
                 ) -> dict:
    fastas, t_gen = _dataset("oracle", scale, seed)
    idx, t_build = _build(fastas, expect_sa)
    runs = [(name, order) for name in configs
            for order in ("ascending", "gnu")]
    times, checks = {"data": t_gen, "build": t_build}, {}
    with _pool(len(runs)) as pool:
        want = {r: pool.submit(_oracle, idx, configs[r[0]][1], "", r[1])
                for r in runs}
        for name, order in runs:
            out = os.path.join(WORK, "oracle", f"{name}.{order}.txt")
            wall, _ = _cli(["mine", *configs[name][0], "--reader-order",
                            order, *idx], out)
            times[f"{name}.{order}"] = wall
            with open(out, "rb") as f:
                got = f.read()
            lines, _ = want[(name, order)].result()
            check(got == lines, f"oracle {name} {order}: dsm mine output "
                  "differs from mine_np")
            checks[f"{name}.{order}.lines"] = got.count(b"\n")
    return {"checks": checks, "times_s": times}


def phase_main(scale: int = 100, seed: int | None = None,
               want: tuple[str, int | None] | None = None,
               expect_sa: str | None = "jax") -> dict:
    want_sha, want_paths = want or golden_scale100_gnu()
    fastas, t_gen = _dataset("main", scale, toydata().GOLDEN_SEED
                             if seed is None else seed)
    idx, t_build = _build(fastas, expect_sa)
    out = os.path.join(WORK, "main", "mined.txt")
    argv = ["mine", *PRODUCTION[0], "--reader-order", "gnu", "-v", *idx]
    cold, _ = _cli(argv, out)
    warm, err = _cli(argv, out)
    with open(out, "rb") as f:
        blob = f.read()
    sha = hashlib.sha256(blob).hexdigest()
    paths = _paths_from(err)
    check(sha == want_sha, f"main: gnu output sha256 {sha} != {want_sha}")
    check(want_paths is None or paths == want_paths,
          f"main: {paths} paths != {want_paths}")
    nlines = blob.count(b"\n")
    ddir = os.path.join(WORK, "main")
    t_dist, _ = _cli(["distance", "-s", str(len(fastas)), "-m", "0.5,1.0",
                      "-F", "smoke", "--outdir", ddir], in_path=out)
    for kind in ("count", "log", "sqrt", "lgamma"):
        with open(os.path.join(ddir, f"{kind}.smoke")) as f:
            text = f.read()
        heads = re.findall(r"computed from (\d+) substrings", text)
        vals = [float(v) for ln in text.splitlines()
                if not ln.startswith("Matrix") for v in ln.split()]
        check(len(heads) == 2 and len(vals) == 2 * len(fastas) ** 2,
              f"distance: {kind}.smoke malformed")
        check(all(v == v and abs(v) != float("inf") for v in vals),
              f"distance: {kind}.smoke has non-finite values")
        # every row's normalized entropy is <= 1.0, so the outer bin
        # holds every mined line
        check(int(heads[1]) == nlines,
              f"distance: {heads[1]} rows binned, {nlines} mined")
    return {"checks": {"sha256": sha[:16], "paths": paths, "lines": nlines},
            "times_s": {"data": t_gen, "build": t_build, "mine_cold": cold,
                        "mine_warm": warm, "distance": t_dist}}


def phase_large(scale: int = 1000, seed: int = FRESH_SEED,
                check_prefixes: tuple[str, ...] = ("ACG", "TTA"),
                expect_sa: str | None = "jax") -> dict:
    fastas, t_gen = _dataset("large", scale, seed)
    idx, t_build = _build(fastas, expect_sa)
    times = {"data": t_gen, "build": t_build}
    checks = {}
    with _pool(len(check_prefixes)) as pool:
        want = {p: pool.submit(_oracle, idx, PRODUCTION[1], p, "ascending")
                for p in check_prefixes}
        paths = lines = 0
        for p in "ACGT":
            out = os.path.join(WORK, "large", f"mined.{p}.txt")
            wall, err = _cli(["mine", *PRODUCTION[0], "--prefix", p, "-v",
                              *idx], out)
            times[f"prefix_{p}"] = wall
            paths += _paths_from(err)
            with open(out, "rb") as f:
                lines += f.read().count(b"\n")
        checks.update(paths=paths, lines=lines)
        for p in check_prefixes:
            out = os.path.join(WORK, "large", f"mined.{p}.txt")
            wall, _ = _cli(["mine", *PRODUCTION[0], "--prefix", p, *idx],
                           out)
            times[f"prefix_{p}"] = wall
            with open(out, "rb") as f:
                got = f.read()
            check(got == want[p].result()[0],
                  f"large: prefix {p} differs from mine_np")
            checks[f"{p}.lines"] = got.count(b"\n")
    return {"checks": checks, "times_s": times}


def _placement(stderr: str, engine: str) -> list[str]:
    m = re.search(rf"^{engine}: table shards (.*)$", stderr, re.M)
    check(m is not None, f"{engine} -v reported no table placement")
    return m.group(1).split(", ")


def phase_four(n_devices: int, scale: int = 100, small_scale: int = 10,
               want: tuple[str, int | None] | None = None,
               expect_sa: str | None = "jax") -> dict:
    """The sample-sharded engines over all `n_devices` devices."""
    want_sha, want_paths = want or golden_scale100_gnu()
    fastas, t_gen = _dataset("four", scale, toydata().GOLDEN_SEED)
    idx, t_build = _build(fastas, expect_sa)
    out = os.path.join(WORK, "four", "mined.txt")
    argv = ["mine", *PRODUCTION[0], "--engine", "sharded-episode",
            "--reader-order", "gnu", "-v", *idx]
    cold, _ = _cli(argv, out)
    warm, err = _cli(argv, out)
    with open(out, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    paths = _paths_from(err)
    check(sha == want_sha, f"four: sharded-episode sha256 {sha}")
    check(want_paths is None or paths == want_paths,
          f"four: sharded-episode {paths} paths != {want_paths}")
    episode_shards = _placement(err, "mine_device_sharded")
    check(len({s.split(":samples")[0] for s in episode_shards})
          == n_devices, f"four: tables not spread: {episode_shards}")

    sfastas, t_sgen = _dataset("four_small", small_scale, FRESH_SEED)
    sidx, t_sbuild = _build(sfastas, expect_sa)
    with _pool(1) as pool:
        want_small = pool.submit(_oracle, sidx, PRODUCTION[1], "",
                                 "ascending")
        sout = os.path.join(WORK, "four_small", "mined.txt")
        t_sharded, serr = _cli(["mine", *PRODUCTION[0], "--engine",
                                "sharded", "-v", *sidx], sout)
        with open(sout, "rb") as f:
            check(f.read() == want_small.result()[0],
                  "four: --engine sharded differs from mine_np")
    sharded_shards = _placement(serr, "mine_sharded")
    return {"checks": {"sha256": sha[:16], "paths": paths,
                       "episode_table_shards": episode_shards,
                       "sharded_table_shards": sharded_shards},
            "times_s": {"data": t_gen + t_sgen, "build": t_build + t_sbuild,
                        "sharded_episode_cold": cold,
                        "sharded_episode_warm": warm,
                        "sharded_scale10": t_sharded}}


def _report(name: str, res: dict, card: str, peak: int | None) -> None:
    res = dict(res, peak_bytes_in_use=peak, times_s={
        k: round(v, 3) for k, v in res["times_s"].items()})
    print(f"[{name}] ok {json.dumps(res)} | {card}", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engines over four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import dsm_tpu  # noqa: F401  (fails outside a checkout)
    from dsm_tpu.utils.jaxsetup import gpu_name_power

    card = gpu_name_power().replace("\n", "; ")
    print(card, flush=True)
    if not args.four_cards:
        # before this process touches JAX: the child needs the card
        _report("gpu-tests", phase_gpu_tests(), card, None)

    from dsm_tpu.utils.jaxsetup import require_gpu, setup_jax

    setup_jax()
    dev = require_gpu()
    import jax

    n = len(jax.devices())
    print(f"jax {jax.__version__}, {dev.platform} {dev.device_kind}, "
          f"{n} device(s)", flush=True)
    if args.four_cards:
        check(n == 4, f"--four-cards needs 4 GPUs, JAX sees {n}")
        _report("four", phase_four(n), card, _peak_bytes())
    else:
        _report("oracle", phase_oracle(), card, _peak_bytes())
        _report("main", phase_main(), card, _peak_bytes())
        _report("large", phase_large(), card, _peak_bytes())
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
