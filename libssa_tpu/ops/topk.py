"""Top-k hit selection with deterministic tie-breaking.

Counterpart of the reference's fixed-capacity min-heap (``src/util/minheap.c``,
SURVEY.md §2): keep the k best (score, seq_id) pairs, ordered by score
descending then seq_id ascending — the tie-break must be fixed so hit lists
are reproducible across chunk sizes, batch orders, devices, and hosts
(SURVEY.md §7 "identical tie-breaking in top-k ordering").

On device we avoid heaps entirely (branchy, serial — wrong shape for a
vector machine):
the sharded sweep sorts on a composite key in-program (parallel/sharded.py)
and the manager reduces accumulated scores on the host here. k is small
(10s), chunks are large (1000s), so sort cost is negligible next to the DP.
"""
from __future__ import annotations

import numpy as np

INVALID_ID = np.int32(2**31 - 1)  # sorts after every real id
NEG_SCORE = np.int32(-(2**31) + 1)


def host_topk(scores: np.ndarray, seq_ids: np.ndarray, k: int):
    """Host-side exact top-k over accumulated per-chunk results."""
    scores = np.asarray(scores, dtype=np.int64)
    seq_ids = np.asarray(seq_ids, dtype=np.int64)
    valid = seq_ids >= 0
    scores, seq_ids = scores[valid], seq_ids[valid]
    order = np.lexsort((seq_ids, -scores))[:k]
    return scores[order], seq_ids[order].astype(np.int32)
