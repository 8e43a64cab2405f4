"""Index construction pipeline — the `builder` CLI equivalent.

Mirrors the reference build flow (builder.cpp:203-285): read FASTA records,
apply the exact transform (normalize, append '-' + reverse complement,
reverse everything — alphabet.transform), insert each record as one text,
then construct the FM-index and save it.

The reference names the artifact `<input>.fmi` (TextCollection::save);
we use `<input>.dsmi` (dsm-tpu index v1, .npz container).
"""

from __future__ import annotations

import sys
import time

from .alphabet import transform
from .fasta import read_fasta
from .fmindex import DEFAULT_SAMPLERATE, FMIndex

INDEX_EXTENSION = ".dsmi"


def libname(path: str) -> str:
    """Sample name from an index/input filename: basename up to the first
    '.' (metaenumerate.cpp:79-88).  This is the name the client announces
    to the server and must match the server's expected-names list."""
    base = path.replace("\\", "/").rsplit("/", 1)[-1]
    return base.split(".", 1)[0]


def build_index(
    input_fasta: str,
    output: str | None = None,
    samplerate: int = DEFAULT_SAMPLERATE,
    sa_backend: str = "auto",
    verbose: bool = False,
    fmt: str = "dsmi",
    buffer_symbols: int = 0,
) -> str:
    t0 = time.time()
    if sa_backend == "auto":
        # the device prefix-doubling sort (ops/sa.py) whenever JAX has
        # an accelerator; the numpy sort on a CPU-only host
        try:
            import jax

            sa_backend = ("jax" if jax.default_backend() != "cpu"
                          else "numpy")
        except Exception:  # pragma: no cover - jax always importable
            sa_backend = "numpy"
        if verbose:
            print(f"builder: sa-backend auto -> {sa_backend}",
                  file=sys.stderr)
    texts = []
    names = []
    for rec in read_fasta(input_fasta):
        texts.append(transform(rec.seq))
        names.append(rec.name)
    if verbose:
        total = sum(len(t) + 1 for t in texts)
        print(
            f"builder: {len(texts)} sequences, n = {total} "
            f"({time.time() - t0:.1f}s read+transform)",
            file=sys.stderr,
        )
    if buffer_symbols:
        # bounded-memory construction: chunked build + index merging
        # (index/incremental.py, the RLCSABuilder flush/merge equivalent)
        from .incremental import IncrementalBuilder

        ib = IncrementalBuilder(buffer_symbols=buffer_symbols,
                                samplerate=samplerate,
                                sa_backend=sa_backend)
        for t, nm in zip(texts, names):
            ib.insert(t, nm)
        idx = ib.finish()
    else:
        idx = FMIndex.from_texts(texts, names, samplerate=samplerate,
                                 sa_backend=sa_backend)
    if fmt == "fmi":
        # reference-compatible artifact (same naming as builder.cpp:283)
        from .fmi_compat import save_fmi

        return save_fmi(idx, output if output is not None else input_fasta)
    out = output if output is not None else input_fasta + INDEX_EXTENSION
    if not out.endswith(INDEX_EXTENSION):
        out += INDEX_EXTENSION
    idx.save(out)
    if verbose:
        print(
            f"builder: saved {out} (n = {idx.n}, "
            f"{time.time() - t0:.1f}s total)",
            file=sys.stderr,
        )
    return out
