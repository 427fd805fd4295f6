"""ctypes bridge to the native Myers-Miller leaf solver.

``native/leafalign.cpp`` runs the leaf direction-matrix Gotoh fill +
traceback at C speed — the Python fill (``hirschberg._ops_small``) pays
~60 us of interpreter overhead per DP row, and the leaf row total equals
the query length regardless of leaf sizing, so it dominated the warm
30k x 30k NW traceback (2.0 of 2.7 s in a host profile).
The Python fill remains the fallback and the differential oracle; this
path is a throughput optimization, never a correctness dependency
(identical recurrences, tie-breaks, and (tb, te) boundary contract —
locked by tests/test_hirschberg.py).

Build: ``make -C native`` (also built into the wheel by setup.py).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_lib = None
_lib_tried = False


def _find_lib():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    here = os.path.dirname(os.path.abspath(__file__))
    candidates = [
        os.path.join(here, "libleafalign.so"),
        os.path.join(here, "..", "io", "libleafalign.so"),
        os.path.join(here, "..", "..", "native", "libleafalign.so"),
    ]
    from ..util.nativebuild import ensure_built

    built = ensure_built("libleafalign.so", "leafalign.cpp")
    if built:
        # Prefer the lazily (re)built library: the wheel-shipped copies
        # above may predate the source or another host's CPU.
        candidates.insert(0, built)
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.leaf_ops.restype = ctypes.c_int64
                lib.leaf_ops.argtypes = [
                    ctypes.POINTER(ctypes.c_int64),  # cost (A, A)
                    ctypes.c_int32,                  # A
                    ctypes.POINTER(ctypes.c_int32),  # q
                    ctypes.c_int64,                  # m
                    ctypes.POINTER(ctypes.c_int32),  # s
                    ctypes.c_int64,                  # n
                    ctypes.c_int64,                  # g
                    ctypes.c_int64,                  # h
                    ctypes.c_int64,                  # tb
                    ctypes.c_int64,                  # te
                    ctypes.POINTER(ctypes.c_uint8),  # ops out (m + n)
                ]
                _lib = lib
                break
            except OSError:
                continue
    return _lib


def native_available() -> bool:
    return _find_lib() is not None


def leaf_ops_native(q, s, cost, g, h, tb, te):
    """Optimal ops list for one leaf, or None when the lib is absent.

    Arguments mirror ``hirschberg._ops_small`` (min-cost form); the
    returned list is identical to its output by construction (same
    recurrences and tie-breaks, differential-tested).
    """
    lib = _find_lib()
    if lib is None:
        return None
    q32 = np.ascontiguousarray(q, np.int32)
    s32 = np.ascontiguousarray(s, np.int32)
    cost64 = np.ascontiguousarray(cost, np.int64)
    m, n = len(q32), len(s32)
    out = np.empty(m + n, np.uint8)
    got = lib.leaf_ops(
        cost64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(cost64.shape[0]),
        q32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(m),
        s32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n),
        ctypes.c_int64(int(g)),
        ctypes.c_int64(int(h)),
        ctypes.c_int64(int(tb)),
        ctypes.c_int64(int(te)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if got < 0:
        return None
    return list(out[:got].tobytes().decode())
