"""On-demand build + ctypes bindings for the native trie-stream codec.

Compiles net/_trieio.cpp with the system g++ into the checkout's `.cache/`
the first time it's needed (sub-second; cached by source hash), and exposes
NativeTrieParser / native_encode with the exact interface semantics of
the pure-Python codec in net/wire.py.  Falls back to None when no
toolchain or no writable checkout cache is available — callers use
wire.TrieParser then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from .wire import CLOSE, OPEN, StreamError

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_trieio.cpp")
_lib = None
_lib_tried = False


class _TrieState(ctypes.Structure):
    _fields_ = [
        ("depth", ctypes.c_uint64),
        ("n", ctypes.c_uint64),
        ("err", ctypes.c_int32),
        ("errmsg", ctypes.c_char * 256),
    ]


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    from ..utils.jaxsetup import CHECKOUT_CACHE

    if CHECKOUT_CACHE is None:
        return None
    cache = os.path.join(CHECKOUT_CACHE, "native")
    sopath = os.path.join(cache, f"_trieio-{tag}.so")
    if os.path.exists(sopath):
        return sopath
    try:
        os.makedirs(cache, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, sopath)
        return sopath
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def get_lib():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    sopath = _build()
    if sopath is None:
        return None
    lib = ctypes.CDLL(sopath)
    lib.trie_parse.restype = ctypes.c_int64
    lib.trie_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_TrieState),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.trie_encode.restype = ctypes.c_int64
    lib.trie_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    _lib = lib
    return _lib


class NativeTrieParser:
    """Drop-in for wire.TrieParser backed by the C++ batch parser."""

    def __init__(self) -> None:
        self._lib = get_lib()
        assert self._lib is not None
        self._st = _TrieState(0, 0, 0, b"")
        self._tail = b""

    @property
    def depth(self) -> int:
        return self._st.depth

    @property
    def n(self) -> int:
        return self._st.n

    @property
    def pending(self) -> int:
        return len(self._tail)

    def feed(self, data: bytes, max_events: int | None = None):
        buf = self._tail + data
        cap = max(len(buf), 16)
        if max_events is not None:
            cap = min(cap, max_events)
        types = np.empty(cap, dtype=np.uint8)
        syms = np.empty(cap, dtype=np.uint8)
        freqs = np.empty(cap, dtype=np.uint64)
        consumed = ctypes.c_int64(0)
        nev = self._lib.trie_parse(
            buf, len(buf), ctypes.byref(self._st),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            syms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cap, ctypes.byref(consumed))
        if self._st.err:
            raise StreamError(self._st.errmsg.decode())
        self._tail = buf[consumed.value:]
        events = []
        for i in range(nev):
            if types[i] == 0:
                events.append((OPEN, int(syms[i])))
            else:
                events.append((CLOSE, int(freqs[i]), int(syms[i])))
        return events

    def feed_arrays(self, data: bytes):
        """Zero-Python-loop variant: -> (types, syms, freqs) numpy arrays."""
        buf = self._tail + data
        cap = max(len(buf), 16)
        types = np.empty(cap, dtype=np.uint8)
        syms = np.empty(cap, dtype=np.uint8)
        freqs = np.empty(cap, dtype=np.uint64)
        consumed = ctypes.c_int64(0)
        nev = self._lib.trie_parse(
            buf, len(buf), ctypes.byref(self._st),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            syms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cap, ctypes.byref(consumed))
        if self._st.err:
            raise StreamError(self._st.errmsg.decode())
        self._tail = buf[consumed.value:]
        return types[:nev].copy(), syms[:nev].copy(), freqs[:nev].copy()


def native_encode(types: np.ndarray, syms: np.ndarray, freqs: np.ndarray,
                  start_n: int = 0, start_depth: int = 0):
    """C++ twin of wire.encode_events -> (bytes, n, depth), or None if no
    native lib."""
    lib = get_lib()
    if lib is None:
        return None
    types = np.ascontiguousarray(types, dtype=np.uint8)
    syms = np.ascontiguousarray(syms, dtype=np.uint8)
    freqs = np.ascontiguousarray(freqs, dtype=np.uint64)
    out = np.empty(max(len(types), 1) * 21, dtype=np.uint8)
    n = ctypes.c_uint64(start_n)
    depth = ctypes.c_uint64(start_depth)
    written = lib.trie_encode(
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        syms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(types),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(n), ctypes.byref(depth))
    return out[:written].tobytes(), n.value, depth.value


def make_parser():
    """Best parser available: native if a toolchain exists, else pure."""
    if get_lib() is not None:
        return NativeTrieParser()
    from .wire import TrieParser

    return TrieParser()
