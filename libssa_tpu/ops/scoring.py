"""Query-profile construction for the device kernels.

Counterpart of the reference's per-search "query profile" (SWIPE dprofile
fill, SURVEY.md §3.2): for a fixed query q, precompute
``profile[i, c] = sub(q[i], c)`` for every alphabet symbol c. At search time
a subject-symbol column of scores is one profile lookup per lane — which the
kernels express as a per-lane gather (the Hopper kernel and the scan's
default) or as a ``profile @ onehot(s_t)`` dot, in place of the reference's
SSE shuffle-based dprofile gather.
"""
from __future__ import annotations

import numpy as np

from ..constants import PADDED_ALPHABET


def make_profile(q_codes: np.ndarray, padded_matrix: np.ndarray) -> np.ndarray:
    """(m, PADDED_ALPHABET) int32 profile for query ``q_codes``.

    ``padded_matrix`` is ``ScoreMatrix.padded()``; pad symbols keep their
    large-negative scores so they can never extend an alignment.
    """
    q = np.asarray(q_codes, dtype=np.intp)
    mat = np.asarray(padded_matrix, dtype=np.int32)
    if mat.shape != (PADDED_ALPHABET, PADDED_ALPHABET):
        raise ValueError(f"expected padded matrix, got {mat.shape}")
    return mat[q]


def make_padded_profile(
    q_codes: np.ndarray, padded_matrix: np.ndarray, rows: int | None = None
) -> np.ndarray:
    """Profile padded with -64 rows to a target height.

    ``rows=None`` pads to the next multiple of 32 — the convention every
    search path shares so query length stops being a free
    kernel-compilation dimension (kernels take the true length as the
    traced ``m_real``; the -64 fill rows can never extend an alignment).
    ``rows=k`` pads to an explicit height (the frame-fanout sweep pads
    all frames to the tallest). One definition for what used to be
    copy-pasted across eight call sites (manager + sharded engines).
    """
    prof = make_profile(q_codes, padded_matrix)
    m = prof.shape[0]
    target = m + ((-m) % 32) if rows is None else rows
    if target < m:
        raise ValueError(f"target rows {target} < query length {m}")
    if target > m:
        prof = np.pad(prof, ((0, target - m), (0, 0)), constant_values=-64)
    return prof
