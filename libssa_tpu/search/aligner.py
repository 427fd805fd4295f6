"""Traceback alignment of top-k hits (COMPUTE_ALIGNMENT stage).

Counterpart of the reference's ``src/algo/aligner.c`` (SURVEY.md §3.3): after
the score search picks the top-k hits, each hit is re-aligned with a full
Gotoh DP + traceback to produce the alignment path, coordinates, and display
strings. Like the reference, this stage is not vectorized across subjects —
k is tiny — but unlike the reference's scalar C loop the matrix fill here is
row-vectorized NumPy using the same exact lazy-E identity the scan kernel
uses for F (symmetric argument, see ops/interseq.py): ~100x faster than a
per-cell Python loop while remaining an implementation INDEPENDENT of both
the scalar oracle (plain per-cell loops) and the device kernels — the three
are cross-checked in tests/test_aligner.py.
"""
from __future__ import annotations

import numpy as np

from ..oracle import NEG, Traceback, _traceback_from, gap_qr


def fill_matrices(q, s, sub, Q: int, R: int, local: bool):
    """Full (m+1, n+1) H, E, F int64 matrices, row-vectorized.

    Row i fill: F row is elementwise from row i-1; the no-E values
    Hnof = max(diag + S, F[, 0]) are exact per cell; E is recovered with a
    prefix max over j of (Hnof + j*R) — exact because extending a gap
    through an E-derived cell never beats extending the gap directly
    (requires Q >= R, guaranteed by gap_qr).
    """
    q = np.asarray(q, dtype=np.intp)
    s = np.asarray(s, dtype=np.intp)
    sub = np.asarray(sub)
    m, n = len(q), len(s)
    # np.empty + fill: np.full with an np.int64 scalar fill value is ~500x
    # slower than a fill() memset on multi-MB arrays (measured).
    H = np.empty((m + 1, n + 1), dtype=np.int64)
    E = np.empty((m + 1, n + 1), dtype=np.int64)
    F = np.empty((m + 1, n + 1), dtype=np.int64)
    H.fill(NEG)
    E.fill(NEG)
    F.fill(NEG)
    H[0, 0] = 0
    js = np.arange(1, n + 1, dtype=np.int64)
    if local:
        H[0, 1:] = 0
        H[1:, 0] = 0
    else:
        H[0, 1:] = -(Q + (js - 1) * R)
        H[1:, 0] = -(Q + (np.arange(1, m + 1, dtype=np.int64) - 1) * R)
    jR = js * R  # offsets for the prefix-max change of variables

    S_rows = sub[q][:, s]  # (m, n) substitution scores
    for i in range(1, m + 1):
        F[i, 1:] = np.maximum(F[i - 1, 1:] - R, H[i - 1, 1:] - Q)
        hnof = np.maximum(H[i - 1, :-1] + S_rows[i - 1], F[i, 1:])
        if local:
            hnof = np.maximum(hnof, 0)
        # E[i, j] = max_{0<=k<j} H[i, k] - Q - (j-1-k) R
        #         = max(H[i, 0], max_{1<=k<j} (hnof_k + k R)) - Q - (j-1) R
        W = hnof + jR  # W[k-1] = hnof_k + k R
        C = np.maximum.accumulate(W)
        prev = np.concatenate(([NEG], C[:-1]))
        prev = np.maximum(prev, H[i, 0])  # gap opened at the row boundary
        E[i, 1:] = prev - Q - (jR - R)
        H[i, 1:] = np.maximum(hnof, E[i, 1:])
    return H, E, F


# Above this many DP cells the full-matrix fill (3 int64 matrices) would
# hold gigabytes; the linear-space Myers-Miller path takes over.
MATRIX_CELL_LIMIT = 16_000_000


def align_pair(
    q: np.ndarray,
    s: np.ndarray,
    sub: np.ndarray,
    gap_open: int,
    gap_extend: int,
    local: bool = True,
    first_residue_opens: bool = True,
) -> Traceback:
    """One optimal alignment of a pair.

    Small pairs: full-matrix fill + traceback. Long pairs (> 16M cells):
    O(m+n)-memory Myers-Miller divide and conquer (search/hirschberg.py)
    — same optimal scores, locked against each other in tests.
    """
    q = np.asarray(q)
    s = np.asarray(s)
    m, n = len(q), len(s)
    if m * n > MATRIX_CELL_LIMIT:
        from .hirschberg import align_pair_linear

        return align_pair_linear(
            q, s, sub, gap_open, gap_extend, local, first_residue_opens
        )
    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    if m == 0 or n == 0:
        if local:
            return Traceback(0, 0, 0, 0, 0, "")
        score = 0 if m == n else -(Q + (max(m, n) - 1) * R)
        return Traceback(score, 0, m, 0, n, "D" * m + "I" * n)
    H, E, F = fill_matrices(q, s, np.asarray(sub), Q, R, local)
    if local:
        i, j = np.unravel_index(int(H.argmax()), H.shape)
        i, j = int(i), int(j)
    else:
        i, j = m, n
    return _traceback_from(H, E, F, q, s, np.asarray(sub), Q, R, i, j, local=local)
