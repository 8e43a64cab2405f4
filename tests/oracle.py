"""Parity oracle: run the REFERENCE binaries end-to-end on localhost.

Replicates the production topology of wrapper-SLURM/example-server.sh:
one metaserver per trie prefix (A, C, G, T) on consecutive ports, one
metaenumerate per sample connecting to all four, exactly as the SLURM
wrappers wire them.  Outputs are frozen under tests/golden/ and the new
framework must match them.

Requires the reference to be compiled somewhere writable (the checkout at
/root/reference is read-only):
    cp -r /root/reference /tmp/refsrc && make -C /tmp/refsrc all
Set DSM_REF_BIN to that directory (default /tmp/refsrc).

Usage: python tests/oracle.py <datadir> <outdir> [--config NAME]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

def _default_ref_bin() -> str:
    checkout = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache", "refsrc")
    for cand in ("/tmp/refsrc", checkout):
        if os.path.exists(os.path.join(cand, "builder")):
            return cand
    return "/tmp/refsrc"


REF_BIN = os.environ.get("DSM_REF_BIN") or _default_ref_bin()
PREFIXES = ["A", "C", "G", "T"]

# Mining configurations to freeze goldens for (server args, client args).
#
# Constraint (reference bug): metaserver's single-active-reader fast path
# traverseOne() skips the depth<=6 'R' checksum bytes the client wrote
# (metaserver.cpp:211-226, "FIXME this should not occur"), desyncing and
# crashing if any depth<=6 node is active in exactly one sample while
# pmin>1.  So configs with pmin>1 keep the client at --fmin 2 (all shallow
# nodes shared on this data); higher fmin only together with --pmin 1.
CONFIGS = {
    # production defaults: wrapper-SLURM client-wrapper.sh --fmin 2,
    # example-server.sh ENTROPY_CUTOFF=1.2
    "default": {"server": ["--emax", "1.2"], "client": ["--fmin", "2"]},
    # sample-specific substrings (metaserver.cpp help: pmin=pmax=1)
    "specific": {
        "server": ["--emax", "10", "--pmin", "1", "--pmax", "1"],
        "client": ["--fmin", "5"],
    },
    # wide-open entropy window: outputs every right/left-branching node
    "wide": {"server": ["--emax", "99"], "client": ["--fmin", "2"]},
    # entropy window + pmin/pmax band + mindepth
    "filtered": {
        "server": ["--emax", "1.5", "--emin", "0.4", "--pmin", "2",
                    "--pmax", "4", "--mindepth", "8"],
        "client": ["--fmin", "2"],
    },
    # maxdepth-capped enumeration
    "shallow": {"server": ["--emax", "1.2"],
                 "client": ["--fmin", "2", "--maxdepth", "12"]},
    # pmin=1: single-reader nodes are output-eligible, deeper fmin is safe
    "deep1": {"server": ["--emax", "99", "--pmin", "1"],
               "client": ["--fmin", "7"]},
}


def build_indexes(datadir: str, samples: list[str]) -> list[str]:
    idx = []
    for s in samples:
        fmi = os.path.join(datadir, s + ".fasta.fmi")
        if not os.path.exists(fmi):
            subprocess.run(
                [os.path.join(REF_BIN, "builder"), s + ".fasta"],
                cwd=datadir, check=True, capture_output=True,
            )
        idx.append(fmi)
    return idx


def run_pipeline(datadir: str, outdir: str, config: str, base_port: int) -> None:
    samples = sorted(
        f[: -len(".fasta")] for f in os.listdir(datadir) if f.endswith(".fasta")
    )
    build_indexes(datadir, samples)
    cfg = CONFIGS[config]
    os.makedirs(outdir, exist_ok=True)
    names = ("\n".join(samples) + "\n").encode()

    servers = []
    for i, prefix in enumerate(PREFIXES):
        out = open(os.path.join(outdir, f"server-output.{config}.{prefix}.txt"), "wb")
        log = open(os.path.join(outdir, f"server.{config}.{prefix}.log"), "wb")
        p = subprocess.Popen(
            [os.path.join(REF_BIN, "metaserver"), "-p", str(base_port + i),
             "-v", *cfg["server"]],
            stdin=subprocess.PIPE, stdout=out, stderr=log, cwd=datadir,
        )
        p.stdin.write(names)
        p.stdin.close()
        servers.append((p, out, log))
    time.sleep(1.0)

    hostinfo = "".join(
        f"localhost {base_port + i} {prefix}\n" for i, prefix in enumerate(PREFIXES)
    ).encode()
    clients = []
    for s in samples:
        p = subprocess.Popen(
            [os.path.join(REF_BIN, "metaenumerate"), *cfg["client"], s + ".fasta.fmi"],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(outdir, f"client.{config}.{s}.log"), "wb"), cwd=datadir,
        )
        p.stdin.write(hostinfo)
        p.stdin.close()
        clients.append(p)

    for p in clients:
        if p.wait(timeout=3600) != 0:
            raise RuntimeError(f"client failed: {p.args}")
    for p, out, log in servers:
        if p.wait(timeout=3600) != 0:
            raise RuntimeError(f"server failed: {p.args}")
        out.close()
        log.close()


if __name__ == "__main__":
    datadir, outdir = sys.argv[1], sys.argv[2]
    only = None
    if "--config" in sys.argv:
        only = sys.argv[sys.argv.index("--config") + 1]
    port = 53310
    for name in CONFIGS:
        if only and name != only:
            continue
        t0 = time.time()
        run_pipeline(datadir, outdir, name, port)
        port += 10
        print(f"config {name}: done in {time.time() - t0:.1f}s")
