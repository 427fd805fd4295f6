"""Anti-diagonal (wavefront) single-pair SW/NW scoring.

**Reference/tests-only since round 4**: no production path routes here.
``api.align_pair`` and the benchmark suite use the skewed-band Pallas
kernel (``ops/longpair``, ~80-124 GCUPS) for single pairs and the
inter-sequence kernel (``ops/interseq.pair_scores_batch``) for batched
pairs; this module is kept as an independent third formulation the test
suite cross-checks those against (tests/test_wavefront.py) and as the
readable exposition of the anti-diagonal dependency structure.

Replacement for the reference's *intra-sequence* striped (Farrar)
vectorization (SURVEY.md §2 P2): where the CPU stripes one DP column across
SSE lanes with a lazy-F fixup loop, this formulation sweeps ANTI-DIAGONALS — on diagonal d = i + j every Gotoh
recurrence reads only diagonals d-1 and d-2, so the whole diagonal updates
as one vectorized op with NO intra-step dependency (not even the F scan the
column formulation needs):

    E[i,j] = max(E[i,j-1] - R, H[i,j-1] - Q)      # same i,   diag d-1
    F[i,j] = max(F[i-1,j] - R, H[i-1,j] - Q)      # i-1,      diag d-1
    H[i,j] = max(H[i-1,j-1] + S(i,j), E, F)       # i-1,      diag d-2

State is O(m) per pair regardless of subject length, which makes this the
long-sequence path: a pair too big for the inter-sequence kernel's (m, B)
column state (SURVEY.md §5 "long-context") still runs here in a few KB.

Implementation notes: the state vectors carry ONLY interior cells
(i >= 1, j >= 1); every boundary reference (row 0 / column 0) is injected
explicitly per step, so both modes initialize all state to -inf. Cells
outside the valid band are kept at -inf and can never win a max.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import PADDED_ALPHABET

NEG = jnp.float32(-(2.0**24))


def _wavefront_score(
    profile, subject, gap_q, gap_r, n_real, *, local: bool, m_real: int | None
):
    """Core single-pair sweep; ``n_real`` a traced scalar <= len(subject).

    Positions beyond ``n_real`` must hold the PAD symbol (callers pad with
    PADDED_ALPHABET-1); they are masked out of every max, so batched pads
    are exact for SW and NW alike.
    """
    m = profile.shape[0]
    mr = m_real if m_real is not None else m
    n = subject.shape[0]
    Q = gap_q.astype(jnp.float32)
    R = gap_r.astype(jnp.float32)
    prof = profile.astype(jnp.float32)  # (m, A)

    ii = jnp.arange(1, m + 1, dtype=jnp.int32)  # query index per lane

    # Padded subject so s[j-1] reads stay in bounds on partial diagonals.
    pad = jnp.full((m + 2,), PADDED_ALPHABET - 1, jnp.int32)
    s_pad = jnp.concatenate([subject.astype(jnp.int32), pad])

    def hb(j):
        """Row boundary H[0][j] (f32, scalar or vector j)."""
        jf = j.astype(jnp.float32) if hasattr(j, "astype") else jnp.float32(j)
        if local:
            return jnp.zeros_like(jf)
        return jnp.where(jf <= 0, 0.0, -(Q + (jf - 1.0) * R))

    def cb(i):
        """Column boundary H[i][0]."""
        return hb(i)  # symmetric

    neg_vec = jnp.full((m,), NEG, jnp.float32)
    best0 = jnp.zeros((), jnp.float32)
    nw0 = NEG

    def step(carry, d):
        Hp, Hc, Ec, Fc, best, nw = carry
        j = d - ii  # (m,) subject index per lane
        valid = (ii <= mr) & (j >= 1) & (j <= n_real)

        # Substitution scores S[i] = sub(q[i], s[j]) as a one-hot
        # reduction over the padded alphabet.
        s_codes = s_pad[jnp.clip(j - 1, 0, n + m + 1)]
        onehot = (
            jax.lax.broadcasted_iota(jnp.int32, (m, PADDED_ALPHABET), 1)
            == s_codes[:, None]
        )
        S = jnp.sum(jnp.where(onehot, prof, 0.0), axis=1)

        # E: from (i, j-1) on diag d-1, same lane; j-1 == 0 -> column bound.
        H_left = jnp.where(j == 1, cb(ii), Hc)
        E_new = jnp.maximum(Ec - R, H_left - Q)

        # F: from (i-1, j) on diag d-1, lane shift; i-1 == 0 -> row bound
        # H[0][j] with j = d-1 for lane i=1.
        Hc_up = jnp.concatenate(
            [jnp.reshape(hb(d - 1), (1,)), Hc[:-1]]
        )
        Fc_up = jnp.concatenate([jnp.full((1,), NEG, jnp.float32), Fc[:-1]])
        F_new = jnp.maximum(Fc_up - R, Hc_up - Q)

        # Diagonal: (i-1, j-1) on diag d-2, lane shift; boundary rows/cols.
        Hp_diag = jnp.concatenate(
            [jnp.full((1,), NEG, jnp.float32), Hp[:-1]]
        )
        Hp_diag = jnp.where(ii - 1 == 0, hb(d - 2), Hp_diag)  # H[0][j-1]
        Hp_diag = jnp.where(j - 1 == 0, cb(ii - 1), Hp_diag)  # H[i-1][0]

        H_new = jnp.maximum(Hp_diag + S, jnp.maximum(E_new, F_new))
        if local:
            H_new = jnp.maximum(H_new, 0.0)
        H_new = jnp.where(valid, H_new, NEG)
        E_new = jnp.where(valid, E_new, NEG)
        F_new = jnp.where(valid, F_new, NEG)

        if local:
            best = jnp.maximum(best, jnp.max(H_new))
        else:
            hit = (ii == mr) & (j == n_real)
            nw = jnp.maximum(nw, jnp.max(jnp.where(hit, H_new, NEG)))
        return (Hc, H_new, E_new, F_new, best, nw), None

    ds = jnp.arange(2, mr + n + 1, dtype=jnp.int32)
    (_, _, _, _, best, nw), _ = jax.lax.scan(
        step, (neg_vec, neg_vec, neg_vec, neg_vec, best0, nw0), ds
    )
    score = best if local else nw
    return score.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("local", "m_real"))
def wavefront_pair_score(
    profile: jax.Array,  # (m, PADDED_ALPHABET) int32 query profile
    subject: jax.Array,  # (n,) int32 codes (exact length, no padding)
    gap_q: jax.Array,  # int32 scalar open+extend
    gap_r: jax.Array,  # int32 scalar extend
    local: bool = True,
    m_real: int | None = None,
):
    """Optimal SW/NW score of one (query, subject) pair, exact int32.

    f32 arithmetic, exact for |score| < 2**24 like the batched kernels.
    ``m_real``: true query length when the profile carries pad rows.
    """
    n = subject.shape[0]
    return _wavefront_score(
        profile, subject, gap_q, gap_r, jnp.int32(n),
        local=local, m_real=m_real,
    )


@functools.partial(jax.jit, static_argnames=("local", "m_real"))
def wavefront_pair_scores_batch(
    profile: jax.Array,  # (m, PADDED_ALPHABET) int32, shared query
    subjects: jax.Array,  # (P, n) int32 codes, PAD-padded
    lengths: jax.Array,  # (P,) int32 true subject lengths
    gap_q: jax.Array,
    gap_r: jax.Array,
    local: bool = True,
    m_real: int | None = None,
):
    """Score one query against P subjects: one dispatch, vmapped sweep.

    ``vmap`` turns the per-diagonal (m,) vectors into (P, m) tiles — real
    vector widths — and a single dispatch replaces one per pair. Exact
    for SW and NW: positions past ``lengths``
    must hold the PAD symbol and are masked out of every max.
    """
    return jax.vmap(
        functools.partial(_wavefront_score, local=local, m_real=m_real),
        in_axes=(None, 0, None, None, 0),
    )(profile, subjects, gap_q, gap_r, lengths.astype(jnp.int32))


def pair_scores_batch(*args, **kwargs):
    """Moved to ``ops.interseq.pair_scores_batch`` (it routes through
    the inter-sequence kernels, not the wavefront; this module is a
    reference/tests-only formulation since round 4)."""
    from .interseq import pair_scores_batch as _psb

    return _psb(*args, **kwargs)


def pair_score(q_codes, s_codes, matrix_padded, gap_open, gap_extend, local=True):
    """Host convenience: exact score of one pair.

    Delegates to ``ops.longpair``'s row-sweep scan, which avoids the
    per-(row, lane) substitution gather of the anti-diagonal formulation
    this module keeps for reference.
    """
    from .longpair import longpair_score

    return longpair_score(
        np.asarray(q_codes), np.asarray(s_codes), matrix_padded,
        gap_open, gap_extend, local=local,
    )
