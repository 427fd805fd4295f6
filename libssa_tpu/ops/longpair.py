"""Single enormous-pair SW/NW scoring: row-sweep with lazy-E prefix scan.

One (query, subject) pair too large for the inter-sequence kernel's batch
shapes. The anti-diagonal formulation (``wavefront.py``) needs a
per-(row, lane) substitution gather on every diagonal; this module avoids
it.

This module reformulates the sweep ROW-major, subject positions across
the vector lanes:

  * Per query row ``i`` the vertical F recurrence is elementwise against
    the previous row (``F = max(F - R, H_prev - Q)``), and the diagonal
    is a single shift of the previous H row.
  * The horizontal E recurrence — the within-row dependency — is closed
    with the SAME lazy prefix-max identity the batched scan uses for F
    (ops/interseq.py), computed over the full row with a log2(n)-level
    doubling scan:

        D[j]   = max_{k<=j} (Hnof[k] - (j-k) R)
        E[j+1] = D[j] - Q

    Scanning ``Hnof`` (H without E) instead of the final H is exact by
    the standard gap-merge lemma (a gap opened from an E-raised cell is
    dominated by extending the original gap, since Q >= R — enforced by
    ``oracle.gap_qr``). The substitution row is ONE dynamic row slice of
    a subject profile, so there is no per-lane gather anywhere.

State is O(n) per pair (rows stream), so memory is flat in the query
length like the reference's intra-sequence path (SURVEY.md §2 P2, §5
"long-context"). This XLA ``lax.scan`` is the single-pair score route on
every backend, in f32 inside the exact 2**24 window and in int32 beyond
it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import PADDED_ALPHABET

NEG_F32 = float(-(2.0**24))
NEG_I32 = -(2**30)


def subject_profile(s_codes: np.ndarray, matrix_padded: np.ndarray) -> np.ndarray:
    """(A, n) substitution profile of the SUBJECT: P[a, j] = sub(a, s[j]).

    The row-sweep's analogue of ``scoring.make_profile`` (which profiles
    the query): per query row the whole substitution row is one dynamic
    slice ``P[q[i]]``.
    """
    return np.asarray(matrix_padded)[:, np.asarray(s_codes, np.intp)]


def _row_sweep(profile_s, q_idx, gap_q, gap_r, m_real, n_real, *, local, dtype):
    """Core scan. ``profile_s`` (A, n_pad); ``q_idx`` (m_pad,) query codes.

    Pad rows (``q_idx`` beyond ``m_real``) must hold the PAD symbol and
    pad columns the PAD symbol in ``profile_s`` (both score -64): SW pad
    cells can never raise the best, and NW captures at the traced
    (m_real, n_real) cell before padding is reached.
    """
    n = profile_s.shape[1]
    NEG = NEG_F32 if dtype == jnp.float32 else NEG_I32
    P = profile_s.astype(dtype)
    Q = jnp.asarray(gap_q, dtype)
    R = jnp.asarray(gap_r, dtype)
    mr = jnp.asarray(m_real, jnp.int32)

    lane = jnp.arange(n, dtype=jnp.int32)
    levels = []
    d = 1
    while d < n:
        levels.append(d)
        d *= 2

    def boundary(i):
        # H[i][0] for NW (i >= 0); SW boundaries are all 0.
        fi = i.astype(dtype) if hasattr(i, "astype") else jnp.asarray(i, dtype)
        return jnp.where(fi <= 0, 0, -(Q + (fi - 1) * R)).astype(dtype)

    def step(carry, qi):
        H, F, i, best, cap = carry
        S = P[qi]  # dynamic row slice, no gather
        F = jnp.maximum(F - R, H - Q)
        if local:
            edge_prev = jnp.asarray(0, dtype)
            ecarry = jnp.asarray(NEG, dtype)
        else:
            edge_prev = boundary(i)  # H[i][0]
            ecarry = boundary(i + 1) - Q  # E entering lane 0
        Hdiag = jnp.concatenate([jnp.reshape(edge_prev, (1,)), H[:-1]])
        Hnof = jnp.maximum(Hdiag + S, F)
        if local:
            Hnof = jnp.maximum(Hnof, 0)
        # Lazy-E: fold the boundary carry into lane 0, then the doubling
        # prefix scan; D[j] = max_{k<=j}(X[k] - (j-k) R).
        D = Hnof.at[0].max(ecarry + Q - R)
        for d in levels:
            shifted = jnp.concatenate([jnp.full((d,), NEG, dtype), D[:-d]])
            D = jnp.maximum(D, shifted - d * R)
        E = jnp.concatenate([jnp.reshape(ecarry, (1,)), (D - Q)[:-1]])
        H_new = jnp.maximum(Hnof, E)
        if local:
            best = jnp.maximum(best, jnp.max(H_new))
        else:
            cap = jnp.where(i == mr - 1, H_new, cap)
        return (H_new, F, i + 1, best, cap), None

    if local:
        H0 = jnp.zeros((n,), dtype)
    else:
        H0 = boundary(lane + 1)  # H[0][j]
    F0 = jnp.full((n,), NEG, dtype)
    (H, F, _, best, cap), _ = jax.lax.scan(
        step,
        (H0, F0, jnp.int32(0), jnp.asarray(0, dtype), jnp.full((n,), NEG, dtype)),
        q_idx.astype(jnp.int32),
    )
    if local:
        return best.astype(jnp.int32)
    return cap[jnp.asarray(n_real, jnp.int32) - 1].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("local", "dtype_name"))
def longpair_score_scan(
    profile_s: jax.Array,  # (A, n_pad) subject profile
    q_idx: jax.Array,  # (m_pad,) query codes, PAD beyond m_real
    gap_q,
    gap_r,
    m_real,
    n_real,
    local: bool = True,
    dtype_name: str = "float32",
):
    """XLA row-sweep score of one pair; exact int32 result.

    ``dtype_name='int32'`` computes in int32 (exact for any realistic
    score; used when the a-priori f32 window bound fails).
    """
    dtype = jnp.float32 if dtype_name == "float32" else jnp.int32
    return _row_sweep(
        profile_s, q_idx, gap_q, gap_r, m_real, n_real,
        local=local, dtype=dtype,
    )


def real_max_abs(matrix: np.ndarray) -> tuple[int, bool]:
    """(max |substitution score| over REAL symbols, had_pad_rows).

    Accepts the raw score table OR a kernel-padded one (``Matrix.padded``
    fills unused rows/cols with -64): uniform pad rows are stripped so the
    fill value doesn't masquerade as a real score.
    """
    matrix = np.asarray(matrix)
    fill = matrix[-1, -1]
    real_rows = ~np.all(matrix == fill, axis=1)
    padded = bool(real_rows.any() and not real_rows.all())
    if padded:
        a = int(np.nonzero(real_rows)[0].max()) + 1
        matrix = matrix[:a, :a]
    return int(np.abs(matrix).max()), padded


def score_bound(m: int, n: int, matrix: np.ndarray, Q: int, R: int) -> int:
    """A-priori bound on |H| anywhere in the DP (f32-window precheck).

    The -64 pad fill is stripped from the max (it inflated the bound ~6x
    and silently routed genome-scale pairs off the kernel-rate f32 path).
    Pad CELLS do participate in the padded kernels' DP, but a pad run only
    adds ``64 * run`` magnitude and runs are bounded by the kernels' pad
    multiples (<= 256 rows + 512 cols); a flat slack covers them.
    """
    mx, padded = real_max_abs(matrix)
    pad_slack = 64 * 1024 if padded else 0  # > 64 * max pad run, any kernel
    return min(m, n) * mx + Q + max(m, n) * R + pad_slack


def longpair_score(
    q_codes: np.ndarray,
    s_codes: np.ndarray,
    matrix_padded: np.ndarray,
    gap_open: int,
    gap_extend: int,
    local: bool = True,
    first_residue_opens: bool = True,
) -> int:
    """Host convenience: exact SW/NW score of one (possibly huge) pair.

    Runs the row-sweep scan; scores that could leave the f32 integer
    window run it in int32 (exact at any realistic magnitude).
    """
    from ..oracle import gap_qr

    Q, R = gap_qr(gap_open, gap_extend, first_residue_opens)
    m, n = len(q_codes), len(s_codes)
    if m == 0 or n == 0:
        if local:
            return 0
        lm = max(m, n)
        return 0 if lm == 0 else -(Q + (lm - 1) * R)

    exact_f32 = score_bound(m, n, matrix_padded, Q, R) < 2**24
    PAD = PADDED_ALPHABET - 1
    n_pad = -(-n // 512) * 512
    m_pad = -(-m // 256) * 256
    P = subject_profile(s_codes, matrix_padded)
    if n_pad > n:
        P = np.pad(P, ((0, 0), (0, n_pad - n)), constant_values=-64)
    qi = np.full((m_pad,), PAD, np.int32)
    qi[:m] = np.asarray(q_codes, np.int32)
    return int(
        longpair_score_scan(
            jnp.asarray(P, jnp.int32), jnp.asarray(qi), Q, R, m, n,
            local=local,
            dtype_name="float32" if exact_f32 else "int32",
        )
    )
