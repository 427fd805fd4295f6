"""Benchmark suite: the five BASELINE.json configs.

Each config prints ONE JSON line. ``bench.py`` (the driver's single-line
hook) stays the kernel-level GCUPS number; this suite measures the
end-to-end pipeline the way the reference's thesis benchmarks do —
sequences/sec and aggregate GCUPS through the full search stack
(packing, streaming, ladder, top-k).

  1  Single query vs single subject, NW, score-only      (kernel-rate paths)
  2  SW affine vs the small bundled protein DB, top-10   (BIT16)
  3  Adaptive 8->16/64 ladder on a 10k-sequence DB       (BIT8)
  4  Batched multi-query search                          (EXACT)
  5  Sharded mesh search + collective top-k merge        (all devices)
  6  Swiss-Prot-scale 500k-seq DB, device-resident       (opt-in)

Usage: python benchmarks/suite.py [--configs 1,2,3,4,5[,6]] [--full] [--cpu]

--full runs config 4 at the BASELINE-spec 100 queries x 100k subjects
(minutes of pure DP); the default is a 10 x 10k slice of the same shape.
--cpu forces the 8-virtual-device CPU backend (tests the sharded path).
Synthetic DBs use a Swiss-Prot-like length distribution (lognormal,
median ~300, clipped to [50, 2000]).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def emit(config: int, metric: str, value: float, unit: str, **detail):
    print(
        json.dumps(
            {
                "config": config,
                "metric": metric,
                "value": round(float(value), 3),
                "unit": unit,
                **detail,
            }
        ),
        flush=True,
    )


def synth_db(n_seqs: int, seed: int):
    from libssa_tpu.constants import SymType
    from libssa_tpu.io.db import SequenceDB

    rng = np.random.default_rng(seed)
    lengths = np.clip(
        rng.lognormal(mean=5.7, sigma=0.55, size=n_seqs).astype(int), 50, 2000
    )
    seqs = [rng.integers(0, 20, L).astype(np.uint8) for L in lengths]
    headers = [f"synth{i}" for i in range(n_seqs)]
    return SequenceDB.from_sequences(headers, seqs, SymType.AMINOACID)


def synth_query(m: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 20, m).astype(np.uint8)


def config1():
    """1 query vs 1 subject, NW global, score-only.

    Batched pairs route through the inter-sequence kernel
    (ops/interseq.pair_scores_batch) — the anti-diagonal skew that held
    round 1 to ~1 GCUPS disappears when pairs sit across lanes. The
    single-pair-latency number (the longpair row-sweep scan — the
    production align_pair route) is emitted alongside.
    """
    import jax.numpy as jnp

    from libssa_tpu import matrices, oracle
    from libssa_tpu.ops.interseq import pair_scores_batch
    from libssa_tpu.ops.longpair import longpair_score
    from libssa_tpu.ops.scoring import make_profile

    mat = matrices.builtin("BLOSUM62")
    m = n = 512
    P = 2048
    q = synth_query(m, 1)
    subs = np.stack([synth_query(n, 2 + i) for i in range(P)])
    prof = jnp.asarray(make_profile(q, mat.padded()), jnp.int32)
    subj = jnp.asarray(subs, jnp.int8)
    gq, gr = 12, 1

    lens = jnp.full((P,), n, jnp.int32)

    def run(sync=True):
        s = pair_scores_batch(prof, subj, lens, gq, gr, local=False, m_real=m)
        return np.asarray(s) if sync else s

    got = run()
    for i in (0, 1, P - 1):
        want = oracle.nw_score(q, subs[i], mat.scores, 11, 1)
        assert got[i] == want, f"batched NW {got[i]} != oracle {want} (pair {i})"

    # Throughput: slope timing (N=1 vs N=10 dispatches + fence, min of 3).
    t1, tn = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        t1.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(9):
            run(sync=False)
        run()
        tn.append(time.perf_counter() - t0)
    dt = (min(tn) - min(t1)) / 9
    emit(
        1, f"1v1 NW pairs/sec (batch {P}/dispatch)", P / dt, "pairs/s",
        gcups=round(P * m * n / dt / 1e9, 3), exact=True, m=m, n=n,
    )

    # Single-pair latency through the row-sweep scan (ops/longpair —
    # the production align_pair(mode=SCORE) route).
    want0 = oracle.nw_score(q, subs[0], mat.scores, 11, 1)
    got0 = longpair_score(q, subs[0], mat.padded(), 11, 1, local=False)
    assert got0 == want0, f"longpair NW {got0} != oracle {want0}"
    t0 = time.perf_counter()
    for _ in range(3):
        longpair_score(q, subs[0], mat.padded(), 11, 1, local=False)
    lat = (time.perf_counter() - t0) / 3
    emit(
        1, "1v1 NW single-pair latency", lat * 1e3, "ms",
        note="longpair row-sweep scan",
    )


def _engine(db, bit_width=None):
    from libssa_tpu import matrices
    from libssa_tpu.search.manager import SearchEngine

    return SearchEngine(db, matrices.builtin("BLOSUM62"), 11, 1)


def config2():
    """SW top-10 against the bundled protein DB (BIT16)."""
    from libssa_tpu.constants import BitWidth, SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.search.manager import SearchStats

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    db = SequenceDB.from_fasta(
        os.path.join(root, "tests", "testdata", "proteins.fas"),
        SymType.AMINOACID,
    )
    eng = _engine(db)
    q = synth_query(256, 3)
    stats = SearchStats()
    eng.search(q, 10, local=True, bit_width=BitWidth.BIT16)  # warm
    best = None
    for _ in range(3):
        stats = SearchStats()
        top_s, top_i = eng.search(
            q, 10, local=True, bit_width=BitWidth.BIT16, stats=stats
        )
        if best is None or stats.seconds < best.seconds:
            best = stats
    stats = best
    emit(
        2, "SW top-10 bundled DB seqs/sec", stats.subjects / stats.seconds,
        "seqs/s", gcups=round(stats.gcups, 2), db_seqs=len(db),
        top_score=int(top_s[0]),
    )


def config3(n_seqs=10_000):
    """Adaptive 8->16/64 precision ladder on a 10k-sequence DB.

    A slice of near-identical subjects (query copies with mutations) makes
    scores exceed the 8-bit window so the rescore rungs genuinely run —
    random-vs-random scores never overflow 255.
    """
    from libssa_tpu.constants import BitWidth, SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.search.manager import SearchStats

    q = synth_query(256, 5)
    rng = np.random.default_rng(44)
    base = synth_db(n_seqs - 50, 4)
    homologs = []
    for i in range(50):
        h = np.tile(q, 3)[: 600 + i]  # high-identity, > 255 score
        mut = rng.random(len(h)) < 0.05
        h = np.where(mut, rng.integers(0, 20, len(h)), h).astype(np.uint8)
        homologs.append(h)
    db = SequenceDB.from_sequences(
        [f"synth{i}" for i in range(n_seqs - 50)]
        + [f"homolog{i}" for i in range(50)],
        [base.sequence(i) for i in range(len(base))] + homologs,
        SymType.AMINOACID,
    )
    eng = _engine(db)
    eng.search(q, 10, local=True, bit_width=BitWidth.BIT8)  # warm/compile
    best = None
    for _ in range(3):
        stats = SearchStats()
        eng.search(q, 10, local=True, bit_width=BitWidth.BIT8, stats=stats)
        if best is None or stats.seconds < best.seconds:
            best = stats
    stats = best
    emit(
        3, "adaptive-ladder 10k-DB seqs/sec", stats.subjects / stats.seconds,
        "seqs/s", gcups=round(stats.gcups, 2),
        rescored=stats.rescored, db_residues=int(db.total_residues),
    )


def config4(n_queries=10, n_seqs=10_000):
    """Batched multi-query SW search (inter-sequence vectorization)."""
    from libssa_tpu.search.manager import SearchStats

    db = synth_db(n_seqs, 6)
    eng = _engine(db)
    queries = [synth_query(256, 100 + i) for i in range(n_queries)]
    eng.search_many(queries, 10, local=True)  # warm/compile (same shapes)
    best = None
    for _ in range(3):
        stats = SearchStats()
        eng.search_many(queries, 10, local=True, stats=stats)
        if best is None or stats.seconds < best.seconds:
            best = stats
    stats = best
    emit(
        4, "multi-query q*s/sec", stats.subjects / stats.seconds, "q*subj/s",
        gcups=round(stats.gcups, 2), queries=n_queries, db_seqs=n_seqs,
    )


def config_nw_multi(n_queries=10, n_seqs=10_000):
    """NW multi-query sweep — must land within ~2x of config 4's SW number
    (VERDICT r1 item 4 done-bar): NW rides the same device top-k since
    the traced-m_real kernels (r2)."""
    from libssa_tpu.search.manager import SearchStats

    db = synth_db(n_seqs, 6)
    eng = _engine(db)
    queries = [synth_query(256, 100 + i) for i in range(n_queries)]
    eng.search_many(queries, 10, local=False)  # warm/compile
    best = None
    for _ in range(3):
        stats = SearchStats()
        eng.search_many(queries, 10, local=False, stats=stats)
        if best is None or stats.seconds < best.seconds:
            best = stats
    stats = best
    emit(
        7, "NW multi-query q*s/sec", stats.subjects / stats.seconds,
        "q*subj/s", gcups=round(stats.gcups, 2), queries=n_queries,
        db_seqs=n_seqs,
    )


def config_translated(n_seqs=100_000):
    """tblastn-style search: protein query vs six-frame-translated
    nucleotide DB, device-reduced top-k (VERDICT r1 item 6 done-bar:
    >= 30% of the plain-search seqs/s at equal residue count)."""
    import numpy as np

    from libssa_tpu.constants import SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.search.manager import SearchEngine, SearchParams, SearchStats
    from libssa_tpu import matrices

    rng = np.random.default_rng(31)
    lens = np.clip(
        rng.lognormal(mean=6.8, sigma=0.5, size=n_seqs).astype(int), 150, 6000
    )
    nt_seqs = [rng.integers(0, 4, int(l)).astype(np.uint8) for l in lens]
    ntdb = SequenceDB.from_sequences(
        [f"nt{i}" for i in range(n_seqs)], nt_seqs, SymType.NUCLEOTIDE
    )
    t0 = time.perf_counter()
    tdb, orig, labels = ntdb.translated(1)
    t_expand = time.perf_counter() - t0
    eng = SearchEngine(
        tdb, matrices.builtin("BLOSUM62"), 11, 1, SearchParams()
    )
    q = synth_query(256, 1)
    eng.search_reduced([q], orig, 10, True)  # warm/compile + upload
    best = None
    for _ in range(3):
        stats = SearchStats()
        r = eng.search_reduced([q], orig, 10, True, stats)
        if best is None or stats.seconds < best.seconds:
            best = stats
    emit(
        8, "translated-search source-seqs/sec", n_seqs / best.seconds,
        "seqs/s", gcups=round(best.gcups, 2),
        nt_residues=int(ntdb.total_residues),
        aa_entries=len(tdb), aa_residues=int(tdb.total_residues),
        expand_seconds=round(t_expand, 2),
        top=(int(r[0][0]), int(r[1][0])) if r else None,
    )


def config_swissprot(n_seqs=500_000):
    """Single query vs a Swiss-Prot-scale DB, device-resident subjects."""
    from libssa_tpu.constants import BitWidth
    from libssa_tpu.search.manager import SearchStats

    db = synth_db(n_seqs, 99)
    eng = _engine(db)
    q = synth_query(256, 1)
    t0 = time.perf_counter()
    eng.prepare(query_length=256)  # pack + upload + compile, one-time
    warmup = time.perf_counter() - t0
    best = None
    for _ in range(3):
        stats = SearchStats()
        s, _ = eng.search(q, 10, local=True, bit_width=BitWidth.BIT8, stats=stats)
        if best is None or stats.seconds < best.seconds:
            best = stats
    emit(
        6, "Swiss-Prot-scale seqs/sec (warm)", n_seqs / best.seconds,
        "seqs/s", gcups=round(best.gcups, 2),
        db_residues=int(db.total_residues),
        warmup_seconds=round(warmup, 1), top_score=int(s[0]),
    )


def config5(n_seqs=5_000):
    """Sharded mesh search with the collective top-k merge."""
    import jax

    from libssa_tpu.parallel.sharded import ShardedSearchEngine, make_db_mesh
    from libssa_tpu import matrices
    from libssa_tpu.search.manager import SearchStats

    db = synth_db(n_seqs, 7)
    mesh = make_db_mesh()
    eng = ShardedSearchEngine(db, matrices.builtin("BLOSUM62"), 11, 1, mesh=mesh)
    sref = _engine(db)
    q = synth_query(256, 8)
    top_s, top_i = eng.search(q, 10)  # warm + correctness
    ref_s, ref_i = sref.search(q, 10)
    assert np.array_equal(np.asarray(top_s), ref_s), "sharded != single-device"
    best = None
    for _ in range(3):
        stats = SearchStats()
        eng.search(q, 10, stats=stats)
        if best is None or stats.seconds < best.seconds:
            best = stats
    stats = best
    emit(
        5, "sharded-mesh seqs/sec", stats.subjects / stats.seconds, "seqs/s",
        gcups=round(stats.gcups, 2), devices=int(mesh.devices.size),
        backend=jax.default_backend(), merged_topk_exact=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")  # 6 = Swiss-Prot scale (opt-in)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")

    from libssa_tpu.util.jaxcache import enable_compilation_cache

    enable_compilation_cache()

    todo = {int(c) for c in args.configs.split(",")}
    if 1 in todo:
        config1()
    if 2 in todo:
        config2()
    if 3 in todo:
        config3()
    if 4 in todo:
        if args.full:
            config4(n_queries=100, n_seqs=100_000)
        else:
            config4()
    if 5 in todo:
        config5()
    if 6 in todo:
        config_swissprot()
    if 7 in todo:
        if args.full:
            config_nw_multi(n_queries=100, n_seqs=100_000)
        else:
            config_nw_multi()
    if 8 in todo:
        config_translated()


if __name__ == "__main__":
    main()
