"""Database-sweep kernel for Hopper GPUs: Pallas on the Triton route.

Scores every (query, chunk) pair of a whole ladder stage — all chunk-shape
groups at once — in one ``pallas_call`` per band of subject lengths, in the
inter-task layout of SWIPE and CUDASW++: one subject per lane (one lane per
thread), the query walked in strips of ``STRIP`` rows whose H and E columns
live in registers for a whole pass over the subject.

Per tile (``LANES`` subjects of one chunk, one query):

  * strips of ``STRIP`` query rows are walked top to bottom; inside a strip
    a ``fori_loop`` walks the subject columns, and the strip's rows are
    unrolled statically. H and E of each row are ``(LANES,)`` register
    vectors; F travels down the strip sequentially (plain Gotoh, no prefix
    scan);
  * the strip's bottom H and F per column go to a per-program edge buffer
    in device memory, which the next strip reads back: 16 bytes per column
    per strip, i.e. 16/STRIP bytes per cell, against the XLA scan's (m, B)
    H/E round trip per column;
  * the substitution score is a per-lane gather from the ``(m, 32)``
    profile row (one load per cell, L1-resident);
  * the column loop stops at the tile's longest subject and the strip loop
    at the query's true length ``m_real``: columns past a subject's end and
    rows past the query only decay scores, so no result needs them.

All groups' chunks are flattened into one code buffer and described by a
per-tile table (query, code offset, column stride, lengths offset, output
offset), so a stage compiles ONE kernel per length band instead of one per
chunk shape. Programs are persistent: a grid of at most ``max_programs``
programs walks the tiles, so the edge buffers stay bounded; each band's
longest subject sizes its edge rows.

Arithmetic is int32 throughout, exact for every score the int32 range holds
(the manager's windows flag anything near it). Outputs are exactly
``interseq.interseq_scores``'s ``(scores, hi, lo)``: SW running best, NW
capture at the traced ``m_real`` and each lane's last column, and the
``track_range`` hi/lo over real cells (rows < m_real, columns < length).
Bit-exactness against the scan and the int64 oracle is locked by
tests/test_triton_kernel.py (interpret mode) and tests/test_gpu.py (card).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import PADDED_ALPHABET

LANES = 128  # subjects per tile: one lane per thread at 4 warps
STRIP = 32  # query rows per strip, held in registers
NUM_WARPS = 4
MAX_PROGRAMS = 4096  # persistent grid cap (many programs per SM)
EDGE_BUDGET = 2 << 30  # bytes of edge buffers across one call's grid
BANDS = (2048, 8192, 32768)  # n_pad bounds of the per-call length bands
NEG = -(2**30)  # -inf surrogate, safe from int32 underflow
BIG = 2**30


def _kernel(
    tq_ref, tcode_ref, tstride_ref, tlen_ref, tout_ref,
    mr_ref, prof_ref, codes_ref, lens_ref,
    s_ref, hi_ref, lo_ref, edge_ref,
    *, Q, R, local, track, n_tiles, n_programs, strip, lanes,
):
    pid = pl.program_id(0)
    n_mine = (n_tiles - pid + n_programs - 1) // n_programs
    zero = jnp.zeros((lanes,), jnp.int32)

    def tile_body(k, carry):
        tile = pid + k * n_programs
        q = tq_ref[tile]
        code0 = tcode_ref[tile]
        stride = tstride_ref[tile]
        out_sl = pl.ds(tout_ref[tile], lanes)
        mr = mr_ref[q]
        lens = lens_ref[pl.ds(tlen_ref[tile], lanes)]
        n_cols = jnp.max(lens)
        n_strips = (mr + strip - 1) // strip
        last = lens - 1

        def strip_body(s, acc):
            best, nw, lo = acc
            row0 = s * strip
            first = s == 0
            # Left boundary of the strip's rows (column 0) and the corner
            # above-left of its first row.
            if local:
                Hs = [zero] * strip
                diag0 = zero
            else:
                Hs = [zero - (Q + (row0 + i) * R) for i in range(strip)]
                diag0 = jnp.where(first, zero, zero - (Q + (row0 - 1) * R))
            Es = [zero + NEG] * strip
            # Row masks for NW capture and the lo range (rows < m_real).
            cap_row = [row0 + i == mr - 1 for i in range(strip)]
            real_row = [row0 + i < mr for i in range(strip)]

            def col_body(t, cc):
                Hs, Es, diag, best, nw, lo = cc
                code = codes_ref[pl.ds(code0 + t * stride, lanes)].astype(
                    jnp.int32
                )
                if local:
                    top = zero
                else:
                    top = zero - (Q + t * R)
                Hup = jnp.where(first, top, edge_ref[pid, 0, t, :])
                F = jnp.where(first, zero + NEG, edge_ref[pid, 1, t, :])
                above = Hup
                d = diag
                newH, newE = [], []
                cap = zero
                colmin = zero + BIG
                for i in range(strip):
                    sub = prof_ref[q, row0 + i, code]
                    e = jnp.maximum(Es[i] - R, Hs[i] - Q)
                    F = jnp.maximum(F - R, above - Q)
                    h = jnp.maximum(d + sub, jnp.maximum(e, F))
                    if local:
                        h = jnp.maximum(h, 0)
                    if local or track:
                        best = jnp.maximum(best, h)
                    if not local:
                        cap = jnp.where(cap_row[i], h, cap)
                        if track:
                            colmin = jnp.minimum(
                                colmin, jnp.where(real_row[i], h, BIG)
                            )
                    d = Hs[i]
                    above = h
                    newH.append(h)
                    newE.append(e)
                edge_ref[pid, 0, t, :] = above
                edge_ref[pid, 1, t, :] = F
                if not local:
                    in_strip = (mr - 1 >= row0) & (mr - 1 < row0 + strip)
                    nw = jnp.where((t == last) & in_strip, cap, nw)
                    if track:
                        lo = jnp.where(t < lens, jnp.minimum(lo, colmin), lo)
                return newH, newE, Hup, best, nw, lo

            _, _, _, best, nw, lo = jax.lax.fori_loop(
                0, n_cols, col_body, (Hs, Es, diag0, best, nw, lo)
            )
            return best, nw, lo

        nw0 = zero - (Q + (mr - 1) * R)
        best, nw, lo = jax.lax.fori_loop(
            0, n_strips, strip_body, (zero, nw0, zero)
        )
        if local:
            s_ref[out_sl] = best
            hi_ref[out_sl] = best
            lo_ref[out_sl] = zero
        else:
            s_ref[out_sl] = nw
            hi_ref[out_sl] = best if track else nw
            lo_ref[out_sl] = lo if track else zero
        return carry

    jax.lax.fori_loop(0, n_mine, tile_body, 0)


@functools.lru_cache(maxsize=256)
def _build(n_tiles, n_out, max_cols, Q, R, local, track, interpret, lanes,
           max_programs):
    edge_bytes = 2 * max_cols * lanes * 4
    n_programs = max(1, min(n_tiles, max_programs, EDGE_BUDGET // edge_bytes))
    kernel = functools.partial(
        _kernel, Q=Q, R=R, local=local, track=track, n_tiles=n_tiles,
        n_programs=n_programs, strip=STRIP, lanes=lanes,
    )
    out = jax.ShapeDtypeStruct((n_out,), jnp.int32)
    return pl.pallas_call(
        kernel,
        grid=(n_programs,),
        out_shape=[
            out, out, out,
            jax.ShapeDtypeStruct((n_programs, 2, max_cols, lanes), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="interseq_sweep",
    )


def _band_call(
    profiles, m_reals, stacks, gap_q, gap_r, *, local, track_range,
    interpret, lanes, max_programs,
):
    """One kernel launch over ``stacks`` (all padded to ``lanes``)."""
    codes_flat, lens_flat, table = [], [], [[], [], [], [], []]
    code_base = len_base = out_base = 0
    outs = []
    for codes, lengths, iq, ic in stacks:
        g, n_pad, B = codes.shape
        P = iq.shape[0]
        nb = B // lanes
        blk = jnp.tile(jnp.arange(nb, dtype=jnp.int32) * lanes, P)
        rep_ic = jnp.repeat(ic.astype(jnp.int32), nb)
        table[0].append(jnp.repeat(iq.astype(jnp.int32), nb))
        table[1].append(code_base + rep_ic * (n_pad * B) + blk)
        table[2].append(jnp.full((P * nb,), B, jnp.int32))
        table[3].append(len_base + rep_ic * B + blk)
        table[4].append(
            out_base + jnp.repeat(jnp.arange(P, dtype=jnp.int32) * B, nb) + blk
        )
        codes_flat.append(codes.reshape(-1))
        lens_flat.append(lengths.reshape(-1))
        outs.append((out_base, P, B))
        code_base += g * n_pad * B
        len_base += g * B
        out_base += P * B
    if code_base >= 2**31:
        raise ValueError("stacked codes exceed int32 offsets; use smaller stages")
    tables = [jnp.concatenate(col) for col in table]
    call = _build(
        int(tables[0].shape[0]), out_base,
        max(codes.shape[1] for codes, *_ in stacks), int(gap_q), int(gap_r),
        bool(local), bool(track_range), bool(interpret), lanes, max_programs,
    )
    s, hi, lo, _ = call(
        *tables,
        jnp.asarray(m_reals, jnp.int32),
        jnp.asarray(profiles, jnp.int32),
        jnp.concatenate(codes_flat).astype(jnp.int8),
        jnp.concatenate(lens_flat).astype(jnp.int32),
    )
    return [
        tuple(x[o : o + P * B].reshape(P, B) for x in (s, hi, lo))
        for o, P, B in outs
    ]


def sweep_scores(
    profiles,  # (n_q, m, PADDED_ALPHABET) int
    stacks,  # [(codes (g, n_pad, B) int8, lengths (g, B), iq (P,), ic (P,))]
    m_reals,  # (n_q,) int32 true query lengths
    gap_q: int,
    gap_r: int,
    *,
    local: bool = True,
    track_range: bool = False,
    interpret: bool = False,
    lanes: int = LANES,
    max_programs: int = MAX_PROGRAMS,
):
    """``[(scores, hi, lo) (P, B) int32]``, one per stack, for every
    (query ``iq[p]``, chunk ``ic[p]``) pair of every stack. ``lanes`` and
    ``max_programs`` shrink the tiles and the grid (tests drive the
    padding and the persistent tile loop with them)."""
    m = profiles.shape[1]
    lanes = min(lanes, max(1 << (c.shape[2] - 1).bit_length() for c, *_ in stacks))
    pad_m = (-m) % STRIP
    if pad_m:
        profiles = jnp.pad(
            profiles, ((0, 0), (0, pad_m), (0, 0)), constant_values=-64
        )
    padded, trims = [], []
    for codes, lengths, iq, ic in stacks:
        B = codes.shape[2]
        pad_b = (-B) % lanes
        if pad_b:
            codes = jnp.pad(
                codes, ((0, 0), (0, 0), (0, pad_b)),
                constant_values=PADDED_ALPHABET - 1,
            )
            lengths = jnp.pad(lengths, ((0, 0), (0, pad_b)))
        padded.append((codes, lengths, jnp.asarray(iq), jnp.asarray(ic)))
        trims.append(B)
    # Length bands: each call's edge rows are sized by its longest chunk,
    # so one long outlier group must not shrink every tile's grid.
    bands: dict[int, list[int]] = {}
    for i, (codes, *_) in enumerate(padded):
        band = next((b for b in BANDS if codes.shape[1] <= b), None)
        bands.setdefault(band, []).append(i)
    results: list = [None] * len(padded)
    for idx in bands.values():
        got = _band_call(
            profiles, m_reals, [padded[i] for i in idx], gap_q, gap_r,
            local=local, track_range=track_range, interpret=interpret,
            lanes=lanes, max_programs=max_programs,
        )
        for i, r in zip(idx, got):
            results[i] = tuple(x[:, : trims[i]] for x in r)
    return results


def interseq_scores_triton(
    profile,  # (m, PADDED_ALPHABET) int
    subjects_T,  # (n_pad, B) int codes
    lengths,  # (B,) int32
    gap_q,
    gap_r,
    local: bool = True,
    use_matmul: bool = False,  # interface parity: the kernel gathers
    track_range: bool = False,
    dtype=jnp.int32,  # interface parity: the kernel computes int32
    m_real=None,
    interpret: bool = False,
):
    """One chunk with ``interseq.interseq_scores``'s signature."""
    del use_matmul, dtype
    m = profile.shape[0]
    mr = m if m_real is None else m_real
    zero = jnp.zeros((1,), jnp.int32)
    [(s, hi, lo)] = sweep_scores(
        jnp.asarray(profile)[None],
        [(
            jnp.asarray(subjects_T).astype(jnp.int8)[None],
            jnp.asarray(lengths)[None], zero, zero,
        )],
        jnp.reshape(jnp.asarray(mr, jnp.int32), (1,)),
        int(gap_q), int(gap_r),
        local=local, track_range=track_range, interpret=interpret,
    )
    return s[0], hi[0], lo[0]
