"""Device-spanning single-pair alignment: ring DP-boundary exchange.

SURVEY.md §5 "long-context": when ONE alignment outgrows a chip, the
subject is sharded column-wise across a device mesh and the Gotoh DP
boundary (an H/E column plus the running F row) flows to the right
neighbor (``ppermute``; NVLink between the cards of one host) — the same
neighbor-exchange dependency pattern as ring attention, the mapping of
"sequence parallelism" for this workload (SURVEY.md §2 P6).

Pipelining: the query is split into ``R`` row blocks. Device ``d``
processes row block ``i`` at phase ``p = i + d`` — a wavefront over the
(row-block, device) grid with ``R + D - 1`` phases and ``R/(R+D-1)``
device utilization. Per phase each device sweeps an (RB x W) tile
column-by-column (the same chunked lazy-F recurrences as the batched
kernels, on (RB,) vectors), then ships its right-edge H/E column to the
next device with ``jax.lax.ppermute``.

Scope: score-only SW/NW for one (query, subject) pair. Requirements kept
static for SPMD simplicity: the subject is padded to ``D * W`` with the
PAD symbol (exact for SW; NW passes the true length and captures at it),
and the query is padded to ``R * RB`` rows with -64 profile rows.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import PADDED_ALPHABET

NEG = jnp.float32(-(2.0**24))


def nw_boundary(i, Q, R):
    """NW boundary value H[i][0] == H[0][i]: 0 at i <= 0, else
    -(Q + (i-1) R)."""
    fi = jnp.asarray(i).astype(jnp.float32)
    return jnp.where(fi <= 0, 0.0, -(Q + (fi - 1.0) * R))


def _tile_sweep(
    prof_block,  # (RB, 32) f32 profile rows of this row block
    s_block,  # (W,) int32 subject columns of this device
    left_H,  # (RB + 1,) H[i0-1 .. i0+RB-1][c0-1]  (row above included)
    left_E,  # (RB,)    E[i0 .. i0+RB-1][c0-1]
    top_H,  # (W + 1,)  H[i0-1][c0-1 .. c0+W-1]    (corner included)
    top_F,  # (W,)      F[i0-1][c0 .. c0+W-1]
    cap_r,  # traced scalar: capture H[cap_r][cap_c] (local tile coords)
    cap_c,  # traced scalar; out-of-range -> nothing captured (NEG)
    Q,
    R,
    *,
    RB: int,
    W: int,
    local: bool,
):
    """Exact Gotoh sweep of one (RB x W) tile, column-major lax.scan.

    Returns (right_H (RB+1,), right_E (RB,), bottom_H (W+1,),
    bottom_F (W,), best, h_cols (RB, W) is NOT kept — score-only).
    """
    prof_T = prof_block.T  # (32, RB) so a scalar symbol indexes a row

    rid = jnp.arange(RB, dtype=jnp.int32)
    masks = []
    d = 1
    while d < RB:
        masks.append(jnp.where(rid >= d, -d * R, NEG))
        d *= 2
    fmask = jnp.where(rid >= 1, -Q, NEG)

    def step(carry, xs):
        Hcol, Ecol, Hup_prev, best, cap = carry
        c, s_c, topH_c, topH_prev, topF_c = xs
        S = prof_T[s_c]  # (RB,)

        E_new = jnp.maximum(Ecol - R, Hcol - Q)
        # Diagonal: H[r-1][c-1] = shift of the previous column, row 0 fed
        # by the top boundary's H[i0-1][c-1].
        H_diag = jnp.concatenate([jnp.reshape(topH_prev, (1,)), Hcol[:-1]])
        Hnof = jnp.maximum(H_diag + S, E_new)
        if local:
            Hnof = jnp.maximum(Hnof, 0.0)
        # F chain, seeded by the top boundary's F/H at this column:
        #   F[0] = max(top_F[c] - R, top_H[c] - Q)
        carry_in = jnp.maximum(topF_c - R, topH_c - Q)
        X = Hnof.at[0].set(jnp.maximum(Hnof[0], carry_in + (Q - R)))
        D_ = X
        dd = 1
        i = 0
        while dd < RB:
            rolled = jnp.concatenate([jnp.full((dd,), NEG), D_[:-dd]])
            D_ = jnp.maximum(D_, rolled + masks[i])
            dd *= 2
            i += 1
        F = jnp.concatenate([jnp.full((1,), NEG), D_[:-1]]) + fmask
        F = F.at[0].set(carry_in)
        H_new = jnp.maximum(Hnof, F)
        if local:
            best = jnp.maximum(best, jnp.max(H_new))
        else:
            # NW end-cell capture at (cap_r, cap_c), any tile position.
            hit = c == cap_c
            val = jax.lax.dynamic_index_in_dim(
                H_new, jnp.clip(cap_r, 0, RB - 1), keepdims=False
            )
            cap = jnp.where(hit, val, cap)
        # Bottom-row outputs for the next row block of this device.
        bot_H = H_new[RB - 1]
        bot_F = F[RB - 1]
        return (H_new, E_new, topH_c, best, cap), (bot_H, bot_F)

    cs = jnp.arange(W, dtype=jnp.int32)
    topH_prevs = top_H[:W]  # H[i0-1][c0-1 .. c0+W-2]
    topH_cs = top_H[1:]  # H[i0-1][c0 .. c0+W-1]
    (Hcol, Ecol, _, best, cap), (bot_H, bot_F) = jax.lax.scan(
        step,
        (left_H[1:], left_E, left_H[0], jnp.float32(0.0), NEG),
        (cs, s_block, topH_cs, topH_prevs, top_F),
    )
    right_H = jnp.concatenate([top_H[W:], Hcol])  # H[i0-1][W] first
    bottom_H = jnp.concatenate([left_H[RB:], bot_H])  # corner first
    return right_H, Ecol, bottom_H, bot_F, best, cap


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "RB", "local", "m_real", "n_real"),
)
def ring_pair_score(
    profile: jax.Array,  # (m, 32) int32, m % RB == 0, replicated
    subject: jax.Array,  # (D*W,) int32, PAD-padded, sharded over 'd'
    gap_q,
    gap_r,
    *,
    mesh: Mesh,
    RB: int = 64,
    local: bool = True,
    m_real: int | None = None,
    n_real: int | None = None,
):
    """SW/NW score of one pair with the subject sharded across the mesh.

    ``n_real``: true subject length (NW capture; defaults to the padded
    length). SW is exact under PAD padding without it.
    """
    m = profile.shape[0]
    if m % RB != 0:  # survives python -O, unlike assert
        raise ValueError(f"profile height {m} must be a multiple of RB={RB}")
    Rblocks = m // RB
    D = mesh.devices.size
    mr = m_real if m_real is not None else m
    nr = n_real if n_real is not None else subject.shape[0]
    Qf = jnp.asarray(gap_q, jnp.float32)
    Rf = jnp.asarray(gap_r, jnp.float32)

    def device_fn(prof, s_shard):
        d = jax.lax.axis_index("d")
        W = s_shard.shape[0]
        s_local = s_shard.astype(jnp.int32)
        prof_f = prof.astype(jnp.float32)

        col0 = d * W  # global index of this device's first column
        # Per-device running state.
        if local:
            top_H = jnp.zeros((W + 1,), jnp.float32)
        else:
            js = col0 + jnp.arange(W + 1, dtype=jnp.int32)
            top_H = nw_boundary(js, Qf, Rf)  # row 0 boundary H[0][j]
        top_F = jnp.full((W,), NEG, jnp.float32)
        inbox_H = jnp.zeros((RB + 1,), jnp.float32)
        inbox_E = jnp.full((RB,), NEG, jnp.float32)
        best = jnp.float32(0.0)
        nw_score = NEG

        perm = [(i, i + 1) for i in range(D - 1)]

        for p in range(Rblocks + D - 1):
            rb = jnp.clip(p - d, 0, Rblocks - 1)
            active = (p - d >= 0) & (p - d <= Rblocks - 1)
            prof_block = jax.lax.dynamic_slice(
                prof_f, (rb * RB, 0), (RB, PADDED_ALPHABET)
            )
            # Left boundary: device 0 computes the global column-0
            # boundary; others use the neighbor's shipped right edge.
            i0 = rb * RB  # global row index of the block's first row - 0
            rows = i0 + jnp.arange(RB + 1, dtype=jnp.int32)  # i0-1+1..i0+RB
            if local:
                edge_H = jnp.zeros((RB + 1,), jnp.float32)
            else:
                edge_H = nw_boundary(rows, Qf, Rf)
            edge_E = jnp.full((RB,), NEG, jnp.float32)
            left_H = jnp.where(d == 0, edge_H, inbox_H)
            left_E = jnp.where(d == 0, edge_E, inbox_E)

            r_in = (mr - 1) - (rb * RB)  # row within block of query end
            c_in = (nr - 1) - col0  # column within shard of subject end
            right_H, right_E, bottom_H, bottom_F, tile_best, cap = _tile_sweep(
                prof_block, s_local, left_H, left_E, top_H, top_F,
                r_in, c_in, Qf, Rf, RB=RB, W=W, local=local,
            )
            if local:
                best = jnp.where(active, jnp.maximum(best, tile_best), best)
            else:
                # Capture H[m_real][n_real] when it lives in this tile.
                hit = (
                    active
                    & (r_in >= 0) & (r_in < RB)
                    & (c_in >= 0) & (c_in < W)
                )
                nw_score = jnp.where(hit, cap, nw_score)
            # Commit per-device top state only for genuinely active phases.
            top_H = jnp.where(active, bottom_H, top_H)
            top_F = jnp.where(active, bottom_F, top_F)
            # Ship the right edge to the next device (non-circular).
            inbox_H = jax.lax.ppermute(
                jnp.where(active, right_H, inbox_H * 0.0), "d", perm
            )
            inbox_E = jax.lax.ppermute(
                jnp.where(active, right_E, inbox_E * 0.0 + NEG), "d", perm
            )

        if local:
            out = jax.lax.pmax(best, "d")
        else:
            out = jax.lax.pmax(nw_score, "d")
        return out  # replicated by the pmax

    out = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(P(), P("d")),
        out_specs=P(),
        check_vma=False,
    )(profile, subject)
    return out.astype(jnp.int32)


def ring_score(
    q_codes: np.ndarray,
    s_codes: np.ndarray,
    matrix_padded: np.ndarray,
    gap_open: int,
    gap_extend: int,
    local: bool = True,
    mesh: Mesh | None = None,
    RB: int = 64,
    first_residue_opens: bool = True,
):
    """Host convenience: pad, shard, and score one pair over the mesh.

    Each device sweeps its tiles with the ``lax.scan`` tile sweep.
    ``first_residue_opens``: the Gotoh gap convention, same meaning as
    ``init_gap_penalties`` (the ring must agree with every other scorer
    for the identical pair and penalties).
    """
    from ..ops.scoring import make_profile
    from ..oracle import gap_qr
    from .sharded import make_db_mesh

    mesh = mesh if mesh is not None else make_db_mesh()
    D = mesh.devices.size
    Q, R_ = gap_qr(gap_open, gap_extend, first_residue_opens)
    m, n = len(q_codes), len(s_codes)
    if m == 0 or n == 0:
        if local:
            return 0
        lm = max(m, n)
        return 0 if lm == 0 else -(Q + (lm - 1) * R_)

    # The tile sweep computes in f32, exact only within +/-2**24 — and
    # the NW boundary term (n * R) alone can leave it on the >8M-column
    # pairs the ring exists for. Escape to the single-device exact path,
    # which has its own int32 fallback at any magnitude.
    from ..ops.longpair import score_bound

    if score_bound(m, n, matrix_padded, Q, R_) >= 2**24:
        from ..constants import OutputMode
        from ..ops.longpair import longpair_score
        from ..util.logging import log

        log(
            OutputMode.WARNING,
            "ring_score: |score| bound exceeds the f32 exactness window; "
            "escaping to the SINGLE-device exact path (ops.longpair — "
            "slower, correct at any magnitude)",
        )
        return longpair_score(
            q_codes, s_codes, matrix_padded, gap_open, gap_extend,
            local=local, first_residue_opens=first_residue_opens,
        )

    from .sharded import put_global

    prof = make_profile(np.asarray(q_codes), matrix_padded)
    pad_m = (-m) % RB
    if pad_m:
        prof = np.pad(prof, ((0, pad_m), (0, 0)), constant_values=-64)
    W = -(-n // D)
    s_pad = np.full((W * D,), PADDED_ALPHABET - 1, np.int64)
    s_pad[:n] = np.asarray(s_codes, np.int64)

    subj = put_global(s_pad, mesh, P("d"), np.int32)
    profile = put_global(prof, mesh, P(), np.int32)
    return int(
        ring_pair_score(
            profile, subj, Q, R_,
            mesh=mesh, RB=RB, local=local, m_real=m, n_real=n,
        )
    )
