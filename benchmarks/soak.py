"""Randomized differential soak: every search path vs the int64 oracle.

Beyond the fixed pytest suite: each trial randomizes the database (sizes,
length ranges, alphabets), matrix (builtin / constant), gap model, query
lengths, ladder entry width, engine (single-device / sharded mesh), and
mode (SW/NW, single/multi-query) — then asserts scores (and, on a sample,
traceback path scores) against the scalar oracle.

Usage: python benchmarks/soak.py [--trials 50] [--seed 0] [--cpu]
Prints one line per 10 trials and a final JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _path_score(q, s, tb, sub, go, ge):
    """Independent evaluation of a traceback path's score."""
    from libssa_tpu.oracle import gap_qr

    Q, R = gap_qr(go, ge)
    i, j = tb.q_begin, tb.s_begin
    total, run = 0, None
    for op in tb.cigar:
        if op == "M":
            total += int(sub[q[i], s[j]])
            i += 1
            j += 1
            run = None
        else:
            total -= R if run == op else Q
            run = op
            if op == "D":
                i += 1
            else:
                j += 1
    assert (i, j) == (tb.q_end, tb.s_end)
    return total


def _check_translated(trng, checked):
    """Translated (blastx/tblastx-style) search vs a frame-by-frame oracle."""
    from libssa_tpu import alphabet, matrices, oracle
    from libssa_tpu.api import SSAContext
    from libssa_tpu.constants import BitWidth, ComputeMode, Strand, SymType

    gencode = int(trng.choice([1, 2, 5, 11]))
    go, ge = int(trng.integers(2, 14)), 1
    n_rec = int(trng.integers(2, 12))
    nt_db = [
        "".join(trng.choice(list("ACGT"), int(trng.integers(9, 120))))
        for _ in range(n_rec)
    ]
    nt_q = "".join(trng.choice(list("ACGT"), int(trng.integers(9, 90))))
    both = bool(trng.integers(0, 2))

    ctx = SSAContext()
    ctx.init_symbol_translation(
        SymType.NUCLEOTIDE,
        Strand.BOTH if both else Strand.FORWARD,
        gencode,
        gencode,
        db_symtype=SymType.NUCLEOTIDE,
    )
    mat = matrices.builtin("BLOSUM62")
    ctx.init_score_matrix("BLOSUM62")
    ctx.init_gap_penalties(go, ge)
    ctx.init_db_fasta(
        "".join(f">r{i}\n{s}\n" for i, s in enumerate(nt_db))
    )
    query = ctx.init_sequence_fasta(nt_q)
    hits = ctx.sw_align(query, k=n_rec, mode=ComputeMode.SCORE)

    qc = alphabet.encode(nt_q, SymType.NUCLEOTIDE)
    q_frames = [alphabet.translate(qc[f:], gencode) for f in range(3)]
    if both:
        rc = alphabet.reverse_complement(qc)
        q_frames += [alphabet.translate(rc[f:], gencode) for f in range(3)]
    q_frames = [f for f in q_frames if len(f)]
    want = {}
    for i, s in enumerate(nt_db):
        sc = alphabet.encode(s, SymType.NUCLEOTIDE)
        best = None
        for src in (sc, alphabet.reverse_complement(sc)):
            for f in range(3):
                aa = alphabet.translate(src[f:], gencode)
                if not len(aa):
                    continue
                for qf in q_frames:
                    v = oracle.sw_score(qf, aa, mat.scores, go, ge)
                    best = v if best is None else max(best, v)
        want[i] = best
    for h in hits:
        assert h.score == want[h.seq_id], (
            f"translated: record {h.seq_id} got {h.score} want {want[h.seq_id]} "
            f"(gencode={gencode} both={both} go={go})"
        )
        checked["translated"] = checked.get("translated", 0) + 1


def _check_fanout_narrow(trng, checked):
    """Fan-out (BOTH-strand) search with a narrow bit width == EXACT.

    r4: narrow widths run the faithful ladder surface on the reduced
    fan-out path (rung stats recorded, recompute elided inside the f32
    window) — hit lists must stay bit-identical to the exact pass."""
    from libssa_tpu import alphabet
    from libssa_tpu.api import SSAContext
    from libssa_tpu.constants import BitWidth, Strand, SymType

    go, ge = int(trng.integers(2, 14)), int(trng.integers(1, 4))
    n_rec = int(trng.integers(2, 20))
    db = [
        "".join(trng.choice(list("ACGT"), int(trng.integers(5, 200))))
        for _ in range(n_rec)
    ]
    ctx = SSAContext()
    ctx.init_symbol_translation(SymType.NUCLEOTIDE, Strand.BOTH)
    ctx.init_constant_scoring(
        int(trng.integers(1, 8)), -int(trng.integers(1, 8))
    )
    ctx.init_gap_penalties(go, ge)
    ctx.init_db_fasta("".join(f">r{i}\n{s}\n" for i, s in enumerate(db)))
    # Query = a DB record (self-match can overflow the 8-bit window).
    query = ctx.init_sequence_fasta(db[int(trng.integers(0, n_rec))])
    k = min(n_rec, int(trng.integers(1, 8)))
    want = ctx.sw_align(query, k=k)
    bw = BitWidth.BIT8 if trng.integers(0, 2) else BitWidth.BIT16
    got = ctx.sw_align(query, k=k, bit_width=bw)
    assert [(h.score, h.seq_id, h.strand) for h in got] == [
        (h.score, h.seq_id, h.strand) for h in want
    ], f"fanout narrow {bw}"
    checked["fanout_narrow"] = checked.get("fanout_narrow", 0) + 1


def _check_beyond_int32(trng, checked):
    """Scores int32 cannot hold: the r4 TRUE 64-bit device lane.

    A match=2**26..2**28 constant matrix and a planted self-hit push the
    optimal score past 2**31. Both the direct BIT64 pass and the EXACT
    ladder (f32 rung -> saturated range flag -> int64 terminal rescore)
    must reproduce the int64 oracle exactly."""
    from libssa_tpu import matrices, oracle
    from libssa_tpu.constants import BitWidth, SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.search.manager import SearchEngine, SearchParams

    # Shapes are pinned to ONE compile (query height 64, subjects <= 64,
    # one 8-lane chunk), so the class reuses a single compilation of the
    # s64 scan kernel.
    match = 2 ** int(trng.integers(26, 29))
    mat = matrices.constant_scoring(match, -int(trng.integers(1, 9)))
    go, ge = int(trng.integers(1, 15)), int(trng.integers(1, 4))
    n = int(trng.integers(2, 9))
    seqs = [
        trng.integers(0, 4, int(trng.integers(2, 60))).astype(np.uint8)
        for _ in range(n)
    ]
    q = trng.integers(0, 4, int(trng.integers(33, 65))).astype(np.uint8)
    seqs[0] = np.tile(q, 2)[:60]
    db = SequenceDB.from_sequences(
        [f"s{i}" for i in range(n)], seqs, SymType.NUCLEOTIDE
    )
    local = bool(trng.integers(0, 2))
    fn = oracle.sw_score if local else oracle.nw_score
    want = np.array([fn(q, s, mat.scores, go, ge) for s in seqs])
    assert want.max() > 2**31, "trial must exceed int32"
    eng = SearchEngine(db, mat, go, ge, SearchParams(batch_size=8))
    for bw in (BitWidth.BIT64, BitWidth.EXACT):
        got = eng.score_all(q, local, bw)
        assert np.array_equal(got, want), (
            f"beyond-int32 {bw} local={local}\n{got}\n{want}"
        )
    checked["beyond_int32"] = checked.get("beyond_int32", 0) + 2 * n


def run_soak(trials: int, seed: int) -> dict:
    from libssa_tpu import matrices, oracle
    from libssa_tpu.constants import BitWidth, SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.parallel.sharded import ShardedSearchEngine, make_db_mesh
    from libssa_tpu.search.aligner import align_pair
    from libssa_tpu.search.manager import SearchEngine, SearchParams

    rng = np.random.default_rng(seed)
    builtins = ["BLOSUM45", "BLOSUM62", "BLOSUM80", "PAM70", "PAM250"]
    # BIT64 is exercised by the dedicated fixed-shape beyond-int32 class,
    # not the per-trial draw: it runs the TRUE s64 device lane, and
    # random shapes here would turn the soak into a compile marathon.
    widths = [BitWidth.BIT8, BitWidth.BIT16, BitWidth.EXACT]
    mesh = make_db_mesh()
    checked = {"scores": 0, "tracebacks": 0, "sharded": 0, "multi": 0}

    t0 = time.perf_counter()
    for trial in range(trials):
        trng = np.random.default_rng(seed * 100_000 + trial)
        nt = bool(trng.integers(0, 4) == 0)
        if nt:
            # a=15 draws IUPAC ambiguity codes: the K=16 select-tree rung
            # (r3 alphabet-sized trees); a=4 the K=5 ACGT rung.
            a = 15 if trng.integers(0, 3) == 0 else 4
            mat = matrices.constant_scoring(
                int(trng.integers(1, 8)), -int(trng.integers(1, 8)),
                SymType.NUCLEOTIDE,
            )
        else:
            # a=24 includes B/Z/X/* — the K=25 tree's odd-tail codes.
            a = 24 if trng.integers(0, 3) == 0 else 20
            if trng.integers(0, 4) == 0:
                mat = matrices.constant_scoring(
                    int(trng.integers(1, 8)), -int(trng.integers(1, 8)),
                    SymType.AMINOACID,
                )
            else:
                mat = matrices.builtin(str(trng.choice(builtins)))
        go = int(trng.integers(1, 20))
        ge = int(trng.integers(1, min(go + 1, 6)))
        if trial % 10 == 9:
            # Big-shape trial: long subjects exercise the kernel's
            # 256-column streaming blocks and the geometric buckets.
            n_seqs = int(trng.integers(50, 300))
            maxlen = int(trng.integers(600, 3000))
        else:
            n_seqs = int(trng.integers(3, 120))
            maxlen = int(trng.integers(6, 300))
        seqs = [
            trng.integers(0, a, int(trng.integers(1, maxlen))).astype(np.uint8)
            for _ in range(n_seqs)
        ]
        # Occasionally plant a homolog to force ladder overflows.
        if trng.integers(0, 16) == 0:
            # Giant query: thousands of rows in every sweep route.
            q = trng.integers(0, a, int(trng.integers(7200, 9500))).astype(
                np.uint8
            )
        else:
            q = trng.integers(0, a, int(trng.integers(1, 200))).astype(np.uint8)
        if trng.integers(0, 2) == 0 and len(q) >= 4:
            seqs[0] = np.tile(q, 1 + int(trng.integers(0, 3)))[: maxlen or 1]
        db = SequenceDB.from_sequences(
            [f"s{i}" for i in range(n_seqs)], seqs, mat.symtype
        )
        local = bool(trng.integers(0, 2))
        bw = widths[int(trng.integers(0, len(widths)))]
        bs = int(trng.choice([8, 32, 128]))
        params = SearchParams(batch_size=bs)

        fn = oracle.sw_score if local else oracle.nw_score
        want = np.array([fn(q, s, mat.scores, go, ge) for s in seqs])

        eng = SearchEngine(db, mat, go, ge, params)
        got = eng.score_all(q, local, bw)
        assert np.array_equal(got, want), (
            f"trial {trial}: engine scores diverge "
            f"(local={local} bw={bw} go={go} ge={ge})\n{got}\n{want}"
        )
        checked["scores"] += n_seqs

        if trial % 3 == 0:
            sh = ShardedSearchEngine(db, mat, go, ge, mesh, params)
            k = min(n_seqs, int(trng.integers(1, 12)))
            s_sh, i_sh = sh.search(q, k, local=local, bit_width=bw)
            order = np.lexsort((np.arange(n_seqs), -want))[:k]
            assert np.array_equal(s_sh, want[order]), f"trial {trial}: sharded"
            checked["sharded"] += k

        if trial % 4 == 0:
            q2 = trng.integers(0, a, int(trng.integers(1, 100))).astype(np.uint8)
            multi = eng.score_all_many([q, q2], local)
            want2 = np.array([fn(q2, s, mat.scores, go, ge) for s in seqs])
            assert np.array_equal(multi[0], want) and np.array_equal(
                multi[1], want2
            ), f"trial {trial}: multi-query"
            checked["multi"] += 2 * n_seqs

        if trial % 5 == 0:
            sid = int(np.argmax(want))
            tb = align_pair(q, seqs[sid], mat.scores, go, ge, local)
            assert tb.score == want[sid], f"trial {trial}: traceback score"
            checked["tracebacks"] += 1

        if trial % 6 == 0:
            _check_translated(trng, checked)

        if trial % 7 == 0:
            # Linear-space (Myers-Miller) traceback vs oracle, incl. the
            # independent path-score evaluation.
            from libssa_tpu.search.hirschberg import align_pair_linear

            sid = int(trng.integers(0, n_seqs))
            tb = align_pair_linear(q, seqs[sid], mat.scores, go, ge, local)
            assert tb.score == want[sid], f"trial {trial}: hirschberg score"
            if tb.cigar:
                ps = _path_score(q, seqs[sid], tb, mat.scores, go, ge)
                assert ps == want[sid], f"trial {trial}: hirschberg path"
            checked["hirschberg"] = checked.get("hirschberg", 0) + 1

        if trial % 11 == 0:
            _check_fanout_narrow(trng, checked)

        if trial % 13 == 5:
            _check_beyond_int32(trng, checked)

        if trial % 8 == 0 and len(q) and len(seqs[0]):
            from libssa_tpu.parallel.ring import ring_score

            sid = int(trng.integers(0, n_seqs))
            rs = ring_score(
                q, seqs[sid], mat.padded(), go, ge, local=local, mesh=mesh,
                RB=32,
            )
            assert rs == want[sid], f"trial {trial}: ring score"
            checked["ring"] = checked.get("ring", 0) + 1

        if trial % 9 == 0 and len(q) and len(seqs[0]):
            # The single-pair path (row-sweep scan) via its product
            # routing.
            from libssa_tpu.ops.longpair import longpair_score

            sid = int(trng.integers(0, n_seqs))
            lp = longpair_score(
                q, seqs[sid], mat.padded(), go, ge, local=local
            )
            assert lp == want[sid], f"trial {trial}: longpair score"
            checked["longpair"] = checked.get("longpair", 0) + 1

        if (trial + 1) % 10 == 0:
            print(
                f"  {trial + 1}/{trials} trials, {checked['scores']} scores "
                f"checked, {time.perf_counter() - t0:.0f}s",
                flush=True,
            )
    return checked


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    checked = run_soak(args.trials, args.seed)
    print(json.dumps({"result": "ALL EXACT", "trials": args.trials, **checked}))


if __name__ == "__main__":
    main()
