"""FM-index over a multi-text DNA collection — flat device layout.

Replaces the reference's FMIndex (FMIndex.h/.cpp: C[256] table + Huffman
wavelet tree + RLCSA construction) with a flat 8-symbol design:

  * build: concatenate each transformed text + terminator, suffix-array by
    prefix doubling (ops/sa.py), BWT by gather — instead of RLCSA's
    incremental Psi-vector construction (rlcsa_builder.cpp).
  * query: `LF(c, i) = C[c] + occ(c, i)` where occ is a sampled-block count
    (ops/rank.py) — the semantics of FMIndex.h:84-90 with the reference's
    inclusive-index convention mapped onto half-open prefix lengths.

Intervals here are half-open [lo, hi): the reference's (smin, smax) is
(lo, hi-1).  pushChar(c) of Query.h:37-45 becomes
    lo' = C[c] + occ(c, lo), hi' = C[c] + occ(c, hi),   empty iff lo' >= hi'.

The index is BIDIRECTIONAL (2BWT): alongside the BWT of the texts it
keeps the BWT of the per-text REVERSED texts (`rtable`).  The mining
engines synchronize an interval in each direction per trie node, which
replaces the reference's four tracked left-extension intervals
(EnumerateQuery.h:44-45) — the reverse interval start is maintained with
lexicographic prefix sums computed from the forward counts, and the
leftChar classification (EnumerateQuery.cpp:77-103) reads the right-
extension counts straight out of the reverse BWT.  10 rank positions per
(node, sample) per level become 4.

The artifact format is a versioned .npz ("dsm-tpu index v2") carrying the
same metadata as the reference's .fmi v17 (FMIndex.cpp:155-217): n,
samplerate, per-symbol counts, number of texts, max text length, names.
v1 artifacts (no reverse table) load with the reverse table reconstructed
by BWT inversion (extract_texts).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..ops.rank import BLOCK, OccTable, occ_prefix_np
from ..ops.sa import bwt_from_sa, suffix_array_np
from . import alphabet
from .alphabet import SIGMA, TERM

FORMAT_VERSION = 2
DEFAULT_SAMPLERATE = 124  # TextCollectionBuilder.h:30 (sampling itself is
#                           disabled in the reference builder, builder.cpp:375)


@dataclass
class SASamples:
    """Sampled suffix array for locate()/getPosition() — the role of the
    reference's optional .sa side file (FMIndex::saveSamples
    FMIndex.cpp:125-147, maketables :572-714; sampling is disabled in the
    reference builder, builder.cpp:375, and mining never locates).

    rows: sorted BWT row indices whose SA value is sampled;
    vals: the SA values;
    text_starts: concatenated-space start of each text, ascending.
    Every text start is sampled (locate() relies on it to terminate
    before any terminator LF step).
    """

    rows: np.ndarray
    vals: np.ndarray
    text_starts: np.ndarray
    # end-marker rank -> doc id (ArrayDoc, FMIndex.h:117-123): lets a
    # locate() walk resolve rows whose BWT entry is a terminator, which
    # happens with reference-built .sa samples (their stride never covers
    # text starts).  Our own builds sample every text start instead.
    endmarker_doc: np.ndarray | None = None


def _rtable_from_texts(code_texts: list[np.ndarray],
                       sa_backend: str = "numpy") -> OccTable:
    """Occ table of the BWT of the per-text reversed collection."""
    parts = []
    for t in code_texts:
        parts.append(t[::-1])
        parts.append(np.array([TERM], dtype=np.int8))
    rcodes = np.concatenate(parts)
    if sa_backend == "jax":
        from ..ops.sa import suffix_array_jax

        rsa = np.asarray(suffix_array_jax(rcodes)).astype(np.int64)
    else:
        rsa = suffix_array_np(rcodes)
    return OccTable.build(bwt_from_sa(rcodes, rsa))


@dataclass
class FMIndex:
    n: int
    table: OccTable
    number_of_texts: int
    max_text_length: int
    samplerate: int = DEFAULT_SAMPLERATE
    names: list[str] = field(default_factory=list)
    sa_samples: SASamples | None = None  # optional locate() support
    _rtable: OccTable | None = None      # reverse-text BWT (lazy for v1/.fmi)

    @property
    def rtable(self) -> OccTable:
        """Reverse-direction occ table (2BWT).  Reconstructed by BWT
        inversion for artifacts that predate it (v1 .npz, reference .fmi)."""
        if self._rtable is None:
            self._rtable = _rtable_from_texts(self.extract_texts())
        return self._rtable

    # ---------------------------------------------------------- construction
    @classmethod
    def from_texts(
        cls,
        texts: Sequence[np.ndarray],
        names: Sequence[str] | None = None,
        samplerate: int = DEFAULT_SAMPLERATE,
        sa_backend: str = "numpy",
        sample_sa: bool = False,
    ) -> "FMIndex":
        """Build from already-transformed texts (uint8 byte arrays, no
        terminators).  Each text contributes len+1 symbols, matching
        TextCollectionBuilder::InsertText (TextCollectionBuilder.cpp:65-92).
        sample_sa=True additionally keeps SA samples every `samplerate`
        text positions for locate()/get_position() (the reference's
        maketables path, disabled in its builder).
        """
        if not texts:
            raise ValueError("cannot index an empty collection")
        parts = []
        lengths = []
        max_len = 0
        for t in texts:
            if len(t) == 0:
                raise ValueError("cannot index empty texts")
            parts.append(alphabet.encode(np.asarray(t, dtype=np.uint8)))
            parts.append(np.array([TERM], dtype=np.int8))
            lengths.append(len(t) + 1)
            max_len = max(max_len, len(t) + 1)
        codes = np.concatenate(parts)
        if sa_backend == "jax":
            from ..ops.sa import suffix_array_jax

            sa = np.asarray(suffix_array_jax(codes)).astype(np.int64)
        else:
            sa = suffix_array_np(codes)
        bwt = bwt_from_sa(codes, sa)
        table = OccTable.build(bwt)
        rtable = _rtable_from_texts(
            [parts[2 * i] for i in range(len(texts))], sa_backend=sa_backend)
        samples = None
        if sample_sa:
            rate = max(1, samplerate)
            starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
            # Sample every text-start position in addition to the regular
            # stride: a locate() walk reaches a text start exactly when the
            # next LF step would be on a terminator, and terminator LF is
            # not well-defined in this pseudo-BWT (the wrap row injects a
            # fake '\0' occurrence into L — see bwt_from_sa).  Sampling the
            # starts guarantees the walk terminates before ever taking it.
            mask = (sa % rate == 0) | np.isin(sa, starts)
            rows = np.flatnonzero(mask)
            samples = SASamples(
                rows=rows.astype(np.int64),
                vals=sa[rows].astype(np.int64),
                text_starts=starts.astype(np.int64),
            )
        return cls(
            n=int(codes.shape[0]),
            table=table,
            number_of_texts=len(texts),
            max_text_length=max_len,
            samplerate=samplerate,
            names=list(names) if names is not None else [],
            sa_samples=samples,
            _rtable=rtable,
        )

    # ---------------------------------------------------------------- queries
    @property
    def C(self) -> np.ndarray:
        return self.table.C

    def occ(self, syms, pos) -> np.ndarray:
        """Count of syms[j] in L[: pos[j]] (prefix-length convention)."""
        return occ_prefix_np(self.table, np.asarray(syms), np.asarray(pos))

    _dcum: np.ndarray | None = None
    _rdcum: np.ndarray | None = None

    @staticmethod
    def _dense_cum(table: OccTable, n: int) -> np.ndarray:
        """Dense (n+1, 5) int32 cumulative <=-counts of codes 1..5 —
        turns a host-side occ/prefix-sum query into one gather (the same
        quantities the device occ_cum kernel produces, ops/rank.py)."""
        flat = table.blocks.reshape(-1)[:n]
        le = flat[:, None] <= np.arange(1, 6, dtype=np.int8)
        cum = np.zeros((n + 1, 5), dtype=np.int32)
        np.cumsum(le, axis=0, out=cum[1:])
        return cum

    @property
    def dcum(self) -> np.ndarray:
        """Forward dense cumulative counts (NumPy oracle engine only)."""
        if self._dcum is None:
            self._dcum = self._dense_cum(self.table, self.n)
        return self._dcum

    @property
    def rdcum(self) -> np.ndarray:
        """Reverse-BWT dense cumulative counts (NumPy oracle engine)."""
        if self._rdcum is None:
            self._rdcum = self._dense_cum(self.rtable, self.n)
        return self._rdcum

    def extract_texts(self) -> list[np.ndarray]:
        """Recover the indexed texts (as int8 code arrays, no terminator)
        by vectorized multi-text BWT inversion — one LF walk per text,
        started at each terminator row (rows [0, numberOfTexts): the '\\0'
        suffixes sort first).  Text order follows terminator-row order,
        which is all any user of the collection's *content* needs (the
        reference reconstructs text via TextStorage instead,
        TextStorage.h:74-96 — we never store plain text)."""
        T = self.number_of_texts
        rows = np.arange(T, dtype=np.int64)
        flat = self.table.blocks.reshape(-1)
        chunks: list[np.ndarray] = []
        alive = np.ones(T, dtype=bool)
        out = np.full((T, self.max_text_length), -1, dtype=np.int8)
        pos = np.zeros(T, dtype=np.int64)
        for _ in range(self.max_text_length + 1):
            c = flat[rows]
            alive &= c != TERM
            if not alive.any():
                break
            out[alive, pos[alive]] = c[alive]
            pos += alive
            step = self.C[c] + occ_prefix_np(self.table, c, rows)
            rows = np.where(alive, step, rows)
        # walks read right-to-left; flip each to text order
        return [out[t, :pos[t]][::-1].copy() for t in range(T)]

    def lf_ref(self, c: int, i: int) -> int:
        """Reference-convention LF (inclusive index, i may be -1):
        C[c] + rank_c(L, i)  (FMIndex.h:84-90)."""
        return int(self.C[c]) + int(self.occ(np.array([c]), np.array([i + 1]))[0])

    def extend(self, c: int, lo, hi):
        """Backward-extend half-open interval(s) [lo, hi) by symbol c."""
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        syms = np.full(lo.shape, c, dtype=np.int8)
        nlo = self.C[c] + self.occ(syms, lo)
        nhi = self.C[c] + self.occ(syms, hi)
        return nlo, nhi

    def count(self, pattern: bytes) -> int:
        """Classic backward search (FMIndex.cpp:360-381): number of
        occurrences of `pattern` in the indexed collection."""
        codes = alphabet.encode(np.frombuffer(pattern, dtype=np.uint8))
        lo, hi = 0, self.n
        for c in codes[::-1]:
            nlo, nhi = self.extend(int(c), lo, hi)
            lo, hi = int(nlo.reshape(-1)[0]), int(nhi.reshape(-1)[0])
            if lo >= hi:
                return 0
        return hi - lo

    def access_bwt(self, i: int) -> int:
        """BWT code at row i (HuffWT::access / FMIndex::getL equivalent)."""
        return int(self.table.blocks[i // BLOCK, i % BLOCK])

    # ------------------------------------------------------------- locate
    def search(self, pattern: bytes) -> tuple[int, int]:
        """Backward search -> half-open row interval (FMIndex::Search,
        FMIndex.cpp:360-381)."""
        codes = alphabet.encode(np.frombuffer(pattern, dtype=np.uint8))
        lo, hi = 0, self.n
        for c in codes[::-1]:
            nlo, nhi = self.extend(int(c), lo, hi)
            lo, hi = int(nlo.reshape(-1)[0]), int(nhi.reshape(-1)[0])
            if lo >= hi:
                return lo, lo
        return lo, hi

    def locate(self, rows) -> np.ndarray:
        """SA values for BWT rows, via sampled-SA LF walks — vectorized
        getPosition (FMIndex.h:105-120).  Requires sample_sa=True at
        build time."""
        if self.sa_samples is None:
            raise ValueError("index was built without SA samples "
                             "(from_texts(sample_sa=True))")
        s = self.sa_samples
        rows = np.asarray(rows, dtype=np.int64).copy()
        out = np.full(rows.shape, -1, dtype=np.int64)
        dist = np.zeros(rows.shape, dtype=np.int64)
        pending = np.ones(rows.shape, dtype=bool)
        flat = self.table.blocks.reshape(-1)
        for _ in range(self.n + 1):
            idx = np.searchsorted(s.rows, rows)
            idx_c = np.minimum(idx, len(s.rows) - 1)
            hit = pending & (s.rows[idx_c] == rows)
            out[hit] = s.vals[idx_c[hit]] + dist[hit]
            pending &= ~hit
            if not pending.any():
                break
            c = flat[rows].astype(np.int64)
            at_term = pending & (c == TERM)
            if at_term.any():
                # the walk met a '\0' BWT entry: this suffix starts at
                # the text following that end-marker (FMIndex.h:117-123)
                if s.endmarker_doc is None:
                    # cannot happen for our own builds: rows with
                    # L == '\0' have SA at a text start, and every text
                    # start is sampled (from_texts)
                    raise AssertionError(
                        "locate walk reached a terminator LF")
                tr = np.flatnonzero(at_term)
                ranks = occ_prefix_np(
                    self.table, np.full(tr.shape, TERM, dtype=np.int8),
                    rows[tr])
                docs = s.endmarker_doc[ranks]
                out[tr] = s.text_starts[docs] + dist[tr]
                pending &= ~at_term
                if not pending.any():
                    break
            # one LF step: SA[next] = SA[row] - 1
            nxt = self.C[c] + occ_prefix_np(
                self.table, c.astype(np.int8), rows)
            rows = np.where(pending, nxt, rows)
            dist += pending
        return out

    def get_position(self, rows) -> tuple[np.ndarray, np.ndarray]:
        """-> (doc_id, in-text offset) per row — TextCollection
        getPosition/getDocId semantics (TextCollection.h:76-88)."""
        pos = self.locate(rows)
        s = self.sa_samples
        doc = np.searchsorted(s.text_starts, pos, side="right") - 1
        return doc, pos - s.text_starts[doc]

    def occurrences(self, pattern: bytes) -> list[tuple[int, int]]:
        """All (doc, offset) occurrences (getOccurrences,
        TextCollection.h:93-96), sorted."""
        lo, hi = self.search(pattern)
        if lo >= hi:
            return []
        doc, off = self.get_position(np.arange(lo, hi))
        return sorted(zip(doc.tolist(), off.tolist()))

    def reads_containing(self, pattern: bytes) -> list[int]:
        """Distinct doc ids with >= 1 occurrence — the ResultSet /
        outputReads role (FMIndex.cpp:427-484) without storing text."""
        lo, hi = self.search(pattern)
        if lo >= hi:
            return []
        doc, _ = self.get_position(np.arange(lo, hi))
        return np.unique(doc).tolist()

    def check(self) -> bool:
        """The metaenumerate --check invariant (metaenumerate.cpp:93-127):
        per-symbol interval sizes must sum to n."""
        total = 0
        for c in range(SIGMA):
            nmin = self.lf_ref(c, -1)
            nmax = self.lf_ref(c, self.n - 1) - 1
            if nmax >= nmin:
                total += nmax - nmin + 1
        return total == self.n

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        meta = {
            "format": "dsm-tpu-index",
            "version": FORMAT_VERSION,
            "n": self.n,
            "samplerate": self.samplerate,
            "number_of_texts": self.number_of_texts,
            "max_text_length": self.max_text_length,
            "names": self.names,
        }
        arrays = {
            "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            "blocks": self.table.blocks,
            "occ": self.table.occ,
            "counts": self.table.counts,
            "C": self.table.C,
            # reverse-direction table (2BWT); occ/counts are cheap to
            # rebuild but storing them keeps load O(read)
            "rblocks": self.rtable.blocks,
            "rocc": self.rtable.occ,
        }
        if self.sa_samples is not None:
            # the reference keeps these in a separate .sa side file
            # (FMIndex::saveSamples); one artifact is simpler
            arrays["sa_rows"] = self.sa_samples.rows
            arrays["sa_vals"] = self.sa_samples.vals
            arrays["sa_starts"] = self.sa_samples.text_starts
            if self.sa_samples.endmarker_doc is not None:
                arrays["sa_emdoc"] = self.sa_samples.endmarker_doc
        with open(path, "wb") as f:  # keep the exact filename (no .npz suffix)
            np.savez_compressed(f, **arrays)

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        """Load an index artifact: our .npz container, or a reference
        .fmi v14-v17 (dispatch by magic, as TextCollection::load
        dispatches by extension, TextCollection.cpp:27-62)."""
        if path.endswith(".rlcsa.array") or path.endswith(".rlcsa.parameters"):
            # TextCollection::load dispatches RLCSA artifacts too
            # (TextCollection.cpp:27-62): decode the Psi position
            # vectors back to the BWT (RLCSA::readBWT semantics,
            # rlcsa.cpp:808-844) and index it with our layout
            from .rlcsa import load_rlcsa

            return load_rlcsa(path)
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic[:2] != b"PK":  # not a zip -> reference binary format
            from .fmi_compat import load_fmi

            return load_fmi(path)
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("format") != "dsm-tpu-index":
                raise ValueError(f"{path}: not a dsm-tpu index")
            if meta["version"] > FORMAT_VERSION:
                raise ValueError(f"{path}: unsupported index version {meta['version']}")
            table = OccTable(
                n=meta["n"],
                blocks=z["blocks"],
                occ=z["occ"],
                counts=z["counts"],
                C=z["C"],
            )
            rtable = None
            if "rblocks" in z.files:  # v2+; v1 reconstructs lazily
                rtable = OccTable(n=meta["n"], blocks=z["rblocks"],
                                  occ=z["rocc"], counts=z["counts"],
                                  C=z["C"])
            samples = None
            if "sa_rows" in z.files:
                samples = SASamples(
                    rows=z["sa_rows"], vals=z["sa_vals"],
                    text_starts=z["sa_starts"],
                    endmarker_doc=(z["sa_emdoc"] if "sa_emdoc" in z.files
                                   else None))
                if meta["version"] < 2 and not np.isin(
                        samples.text_starts, samples.vals).all():
                    # pre-v2 stride-only samples: a locate() walk could
                    # reach a terminator LF mid-walk; drop them so locate
                    # fails fast with a clear "built without SA samples"
                    samples = None
            return cls(
                n=meta["n"],
                table=table,
                number_of_texts=meta["number_of_texts"],
                max_text_length=meta["max_text_length"],
                samplerate=meta["samplerate"],
                names=list(meta["names"]),
                sa_samples=samples,
                _rtable=rtable,
            )
