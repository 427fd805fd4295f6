"""Kernel dispatch: one rule picks the database-sweep route.

Counterpart of the reference's runtime CPU dispatch (``src/cpu_config.c``,
SURVEY.md §2: cpuid selects SSE vs AVX2 kernels at runtime). Here the
choice is between the Hopper kernel (``ops/interseq_triton``, Pallas on the
Triton route) on a GPU backend and the portable XLA ``lax.scan`` kernel
(``ops/interseq``) everywhere else. ``force`` pins a route for testing, as
the reference can pin a SIMD level: "scan", "pallas" (the compiled Hopper
kernel, GPU only) or "interpret" (the same kernel in Pallas interpret mode,
for CPU tests; never chosen automatically).
"""
from __future__ import annotations

import functools

import jax

from ..ops import interseq

ROUTES = ("auto", "scan", "pallas", "interpret")
# The kernel computes int32 with a -2**30 sentinel: every cell is exact
# while the a-priori |score| bound stays below this.
KERNEL_SCORE_LIMIT = 2**29


def route(
    force: str | None = None,
    dtype_str: str = "float32",
    score_bound: int = 0,
) -> str:
    """The sweep route for a request: "scan", "pallas" or "interpret".

    The int64 lane, and any request whose a-priori ``score_bound``
    (``ops.longpair.score_bound``) could overflow the kernel's int32
    cells, always run the scan, whatever is forced.
    """
    if force not in (None, *ROUTES):
        raise ValueError(f"unknown kernel {force!r}; expected one of {ROUTES}")
    if dtype_str == "int64" or score_bound >= KERNEL_SCORE_LIMIT:
        return "scan"
    if force not in (None, "auto"):
        return force
    return "pallas" if jax.default_backend() == "gpu" else "scan"


def sweep_groups(
    route_name, profiles, stacks, m_reals, gap_q, gap_r, *,
    local, use_matmul, track_range, dtype,
):
    """``[(scores, hi, lo) (P, B)]`` per stack entry ``(codes (g, n_pad,
    B), lengths (g, B), iq (P,), ic (P,))``: every (query ``iq[p]``, chunk
    ``ic[p]``) pair of every same-shape group, with ``profiles (n_q, m,
    32)`` and ``m_reals (n_q,)``.

    The Hopper kernel covers all groups in one launch per length band; the
    scan maps ``interseq_scores`` over each group's pairs.
    """
    import jax.numpy as jnp

    if route_name in ("pallas", "interpret"):
        from ..ops import interseq_triton

        return interseq_triton.sweep_scores(
            profiles, stacks, m_reals, gap_q, gap_r, local=local,
            track_range=track_range, interpret=route_name == "interpret",
        )

    def one(codes, lengths):
        def f(x):
            qi, ci = x
            return interseq.interseq_scores(
                profiles[qi], codes[ci], lengths[ci],
                jnp.asarray(gap_q, jnp.int32), jnp.asarray(gap_r, jnp.int32),
                local=local, use_matmul=use_matmul, track_range=track_range,
                dtype=dtype, m_real=m_reals[qi],
            )

        return f

    return [
        jax.lax.map(one(codes, lengths), (iq, ic))
        for codes, lengths, iq, ic in stacks
    ]


def single_query(profile, stacks, m_real):
    """``sweep_groups`` arguments that sweep one profile over every chunk
    of ``stacks`` (``(codes, lengths, ...)`` entries)."""
    import jax.numpy as jnp

    pairs = [
        (
            codes, lengths, jnp.zeros((codes.shape[0],), jnp.int32),
            jnp.arange(codes.shape[0], dtype=jnp.int32),
        )
        for codes, lengths, *_ in stacks
    ]
    return profile[None], pairs, jnp.reshape(jnp.asarray(m_real, jnp.int32), (1,))


def stage_sweep(
    kernel_name: str,
    gap_q: int,
    gap_r: int,
    local: bool,
    use_matmul: bool,
    dtype_str: str,
    eff_limit: int | None,
    nlimit: int | None = None,
):
    """Normalize args BEFORE the cache so equivalent requests share one
    closure set (e.g. int64 forces the scan kernel and the take-gather;
    keying on the pre-override values would duplicate the jitted sweeps
    and their retraces)."""
    kernel_name = route(kernel_name, dtype_str)
    if dtype_str == "int64":
        use_matmul = False  # s64 never rides the one-hot dot
    if kernel_name != "scan":
        use_matmul = False  # the kernel gathers; the flag is scan-only
    return _stage_sweep_cached(
        kernel_name, gap_q, gap_r, local, use_matmul, dtype_str, eff_limit,
        nlimit,
    )


@functools.lru_cache(maxsize=128)
def _stage_sweep_cached(
    kernel_name: str,
    gap_q: int,
    gap_r: int,
    local: bool,
    use_matmul: bool,
    dtype_str: str,
    eff_limit: int | None,
    nlimit: int | None = None,
):
    """ONE-dispatch sweep of a whole precision-ladder stage.

    Every same-shape chunk group is scored by one ``sweep_groups`` call
    (one kernel launch per length band on the Hopper route), the results are
    flattened and concatenated on-device, and the ladder's overflow flags
    are computed in the same program — so a stage is exactly one execute
    plus one fetch.

    Returns ``sweep(profile, stacks, m_real) -> (scores_flat, flags_flat)``
    where ``stacks`` is a tuple of ``(codes (g, n_pad, B) int8, lengths
    (g, B))`` pairs (one per chunk shape) and the flat outputs follow the
    stack order row-major. ``flags_flat`` is all-False when ``eff_limit``
    is None. Also returns ``sweep_multi(profiles, stacks_with_pairs,
    m_reals)`` where each stack entry is ``(codes, lengths, iq (P,),
    ic (P,))`` mapping query/chunk index pairs for the multi-query sweep.

    ``m_real`` is a TRACED runtime argument, so NW query lengths neither
    fragment the jit cache nor force one dispatch per query — ``m_reals``
    is a per-query vector indexed inside the sweep.

    ``nlimit`` is the REQUESTED narrow bit-width window (255 / 32767) on
    the fan-out sweeps (``sweep_multi_topk``/``sweep_reduced``): they
    additionally count lanes whose score range leaves ``[lo, nlimit]`` and
    return that count so the caller reports faithful rescore rung
    statistics. ``eff_limit`` stays the f32 EXACTNESS window that gates the
    any-overflow fallback — the two are deliberately separate limits:
    leaving the narrow window is a statistics event (the scores are already
    exact inside the f32 window, so the rescore is elided exactly as in
    ``manager._ladder_search_device``); leaving the f32 window is a
    correctness event.
    """
    import jax.numpy as jnp

    dtype = {"float32": jnp.float32, "int64": jnp.int64}.get(dtype_str, jnp.int32)
    track = eff_limit is not None or nlimit is not None

    def groups(profiles, stacks, m_reals):
        return sweep_groups(
            kernel_name, profiles, stacks, m_reals, gap_q, gap_r,
            local=local, use_matmul=use_matmul, track_range=track,
            dtype=dtype,
        )

    def _flat(parts):
        s = jnp.concatenate([s.reshape(-1) for s, _, _ in parts])
        if eff_limit is not None:
            f = jnp.concatenate(
                [
                    interseq.overflow_flags(s_, hi, lo, eff_limit, local)
                    .reshape(-1)
                    for s_, hi, lo in parts
                ]
            )
        else:
            f = jnp.zeros(s.shape, bool)
        return s, f

    @jax.jit
    def sweep(profile, stacks, m_real=None):
        mr = profile.shape[0] if m_real is None else m_real
        return _flat(groups(*single_query(profile, stacks, mr)))

    @jax.jit
    def sweep_multi(profiles, stacks, m_reals=None):
        if m_reals is None:
            m_reals = jnp.full((profiles.shape[0],), profiles.shape[1], jnp.int32)
        return _flat(groups(profiles, stacks, m_reals))

    @functools.partial(jax.jit, static_argnames=("k", "n_queries"))
    def sweep_multi_topk(profiles, stacks, m_reals, k: int, n_queries: int):
        """Multi-query sweep reduced to per-query top-k ON DEVICE.

        Fetching full (Q, n_subjects) score matrices would move far more
        than the answer needs. Here every (query, chunk)
        result is tagged with its query index and global subject ids, one
        composite sort groups by (query, -score, id) — the host_topk
        tie-break — and only (Q, k) top lists plus an any-overflow scalar
        leave the device. Stacks entries: (codes, lens, ids (g, B) int32,
        iq, ic).
        """
        import jax.numpy as jnp

        NEG = jnp.int32(-(2**31) + 1)
        INVALID = jnp.int32(2**31 - 1)
        if m_reals is None:
            m_reals = jnp.full(
                (profiles.shape[0],), profiles.shape[1], jnp.int32
            )
        parts_s, parts_i, parts_q, any_f = [], [], [], jnp.bool_(False)
        n_flagged = jnp.int32(0)
        scored = groups(
            profiles,
            [(codes, lens, iq, ic) for codes, lens, _, iq, ic in stacks],
            m_reals,
        )
        for (_, _, ids, iq, ic), (s, hi, lo) in zip(stacks, scored):  # (P, B)
            ids_rows = ids[ic]  # (P, B) global subject ids, -1 padding
            valid = ids_rows >= 0
            if eff_limit is not None:
                f = interseq.overflow_flags(s, hi, lo, eff_limit, local)
                any_f = any_f | jnp.any(f & valid)
            if nlimit is not None:
                fn_ = interseq.overflow_flags(s, hi, lo, nlimit, local)
                n_flagged = n_flagged + jnp.sum(
                    (fn_ & valid).astype(jnp.int32)
                )
            parts_s.append(
                jnp.where(valid, s.astype(jnp.int32), NEG).reshape(-1)
            )
            parts_i.append(
                jnp.where(valid, ids_rows, INVALID).reshape(-1)
            )
            parts_q.append(
                jnp.broadcast_to(iq[:, None], ids_rows.shape).reshape(-1)
            )
        s = jnp.concatenate(parts_s)
        i = jnp.concatenate(parts_i)
        qv = jnp.concatenate(parts_q)
        _, neg_s, idx = jax.lax.sort((qv, -s, i), num_keys=3)
        per_q = s.shape[0] // n_queries
        kk = min(k, per_q)
        top_s = (-neg_s).reshape(n_queries, per_q)[:, :kk]
        top_i = idx.reshape(n_queries, per_q)[:, :kk]
        return top_s, top_i, any_f, n_flagged

    @functools.partial(jax.jit, static_argnames=("k",))
    def sweep_ladder_topk(profile, stacks, m_real, k: int):
        """Whole narrow-width search in ONE dispatch + ONE small fetch.

        Fuses the ladder's first rung, the overflow flags, and the
        device top-k (VERDICT r2 weak #1 / next-round #3: a BIT8 search
        on a small DB used to pay a full score fetch plus separate
        top-k and flag trips). Stacks entries: (codes, lens, ids (g, B)).

        Returns ``(out, s_flat, ids_flat)`` where ``out`` is one int32
        vector ``[top_s (k') | top_i (k') | packed_flags (ceil(N/32))]``
        — the ONLY thing the caller fetches; flags ride as 32x-packed
        bits so even a 500k-lane sweep adds ~60 KB to the fetch. The
        unfetched ``s_flat``/``ids_flat`` stay on device for the rare
        overflow rescore-scatter second pass.
        """
        import jax.numpy as jnp

        NEG = jnp.int32(-(2**31) + 1)
        INVALID = jnp.int32(2**31 - 1)
        parts = groups(*single_query(profile, stacks, m_real))
        s, f = _flat(parts)
        ids = jnp.concatenate([ids.reshape(-1) for _, _, ids in stacks])
        valid = ids >= 0
        s_m = jnp.where(valid, s.astype(jnp.int32), NEG)
        i_m = jnp.where(valid, ids, INVALID)
        neg_s, top_ids = jax.lax.sort((-s_m, i_m), num_keys=2)
        kk = min(k, int(s.shape[0]))
        # Bit-pack the per-lane flags: 32 lanes per int32 word.
        n_lanes = int(s.shape[0])
        n_pad = -(-n_lanes // 32) * 32
        fi = jnp.pad((f & valid).astype(jnp.int32), (0, n_pad - n_lanes))
        packed = jnp.sum(
            fi.reshape(-1, 32) << jnp.arange(32, dtype=jnp.int32)[None, :],
            axis=1,
            dtype=jnp.int32,
        )
        out = jnp.concatenate([-neg_s[:kk], top_ids[:kk], packed])
        return out, s_m, i_m

    @functools.partial(jax.jit, static_argnames=("k", "n_frames"))
    def sweep_reduced(profiles, stacks, m_reals, group_of, k: int, n_frames: int):
        """Frame-fanout sweep reduced to ONE top-k list on device.

        The translated-search path (nucleotide query and/or DB expanded
        into reading frames; SURVEY.md §2 "Symbol translation"): scores
        every (query-frame, chunk) pair, then reduces ON DEVICE in the
        exact host-semantics order (no full score matrix leaves the device):

          1. best-over-frames per DB entry, FIRST frame winning ties
             (``argmax`` returns the first maximum; iq is frame-major);
          2. best entry per source record (``group_of`` maps entry id ->
             record id; identity for plain DBs), lowest entry id on ties;
          3. (score desc, record asc) top-k — host_topk's tie-break.

        Returns (top_s, top_rec, top_entry, top_frame (k,), any_f,
        n_flagged); rows beyond the valid candidate count come back as
        INVALID. ``n_flagged`` counts DB entries whose score range left
        the requested narrow window in ANY frame (0 when ``nlimit`` is
        None) — the faithful rescore rung statistic.
        """
        import jax.numpy as jnp

        NEG = jnp.int32(-(2**31) + 1)
        INVALID = jnp.int32(2**31 - 1)
        parts = []  # (s, e, r, f) flattened per stack group
        any_f = jnp.bool_(False)
        n_flagged = jnp.int32(0)
        scored = groups(
            profiles,
            [(codes, lens, iq, ic) for codes, lens, _, iq, ic in stacks],
            m_reals,
        )
        for (_, _, ids, iq, ic), (s, hi, lo) in zip(stacks, scored):  # (F*C, B)
            nC = s.shape[0] // n_frames
            ids_rows = ids[ic[:nC]]  # (C, B) entry ids, -1 padding
            valid = ids_rows >= 0
            if eff_limit is not None:
                fl = interseq.overflow_flags(s, hi, lo, eff_limit, local)
                any_f = any_f | jnp.any(
                    fl & jnp.tile(valid, (n_frames, 1))
                )
            if nlimit is not None:
                fn_ = interseq.overflow_flags(s, hi, lo, nlimit, local)
                # Entry-level: flagged in ANY frame (each entry sits in
                # exactly one lane, so the sum counts distinct entries).
                fn_any = jnp.any(
                    fn_.reshape(n_frames, nC, s.shape[1]), axis=0
                )
                n_flagged = n_flagged + jnp.sum(
                    (fn_any & valid).astype(jnp.int32)
                )
            s3 = s.reshape(n_frames, nC, s.shape[1]).astype(jnp.int32)
            fmax = jnp.max(s3, axis=0)  # (C, B)
            farg = jnp.argmax(s3, axis=0).astype(jnp.int32)  # first max
            rec_rows = jnp.where(
                valid, group_of[jnp.maximum(ids_rows, 0)], INVALID
            )
            parts.append(
                (
                    jnp.where(valid, fmax, NEG).reshape(-1),
                    jnp.where(valid, ids_rows, INVALID).reshape(-1),
                    rec_rows.reshape(-1),
                    farg.reshape(-1),
                )
            )
        s = jnp.concatenate([p[0] for p in parts])
        e = jnp.concatenate([p[1] for p in parts])
        r = jnp.concatenate([p[2] for p in parts])
        fr = jnp.concatenate([p[3] for p in parts])
        # Best entry per record: sort groups records together with best
        # (score, entry) first; keep only each record's first row.
        r1, neg_s1, e1, f1 = jax.lax.sort((r, -s, e, fr), num_keys=3)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), r1[1:] != r1[:-1]]
        )
        s2 = jnp.where(first, -neg_s1, NEG)
        r2 = jnp.where(first, r1, INVALID)
        # Final (score desc, record asc) ranking.
        neg_s3, r3, e3, f3 = jax.lax.sort((-s2, r2, e1, f1), num_keys=2)
        kk = min(k, int(s.shape[0]))
        return -neg_s3[:kk], r3[:kk], e3[:kk], f3[:kk], any_f, n_flagged

    return sweep, sweep_multi, sweep_multi_topk, sweep_reduced, sweep_ladder_topk
