#!/usr/bin/env python3
"""Smoke run of the sequence-search engine on NVIDIA GPUs.

Run from the root of a checkout:

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # only the 4-card mesh path

One card, one process, in order:

1. device: stop unless JAX's first device is a GPU; print its kind, the JAX
   version, XLA_FLAGS and the card's name and power limit (nvidia-smi, run
   in a child process that does not import JAX);
2. kernel: the database-sweep routes at m=256, B=8192, n=512 — the Hopper
   kernel and the XLA scan (take and one-hot dot gathers) — compared on
   every lane and against the int64 oracle on 64 sampled lanes, SW and NW;
   median of 5 timings each;
3. search: a 500,000-sequence protein database (seeded, bench.py's length
   distribution) written as FASTA and loaded through ``init_db_fasta``;
   ``sw_align``/``nw_align`` for queries of 144, 375, 1,000 and 5,478
   residues in SCORE mode at EXACT/BIT8/BIT16 (identical hit lists), BIT64
   (SW) and ALIGNMENT mode; ``SearchEngine.search_many`` and a translated
   ``search_reduced``. Every hit is re-scored by the scalar oracle, every
   CIGAR re-scores to its hit, and 500 sampled subjects per query equal the
   row-vectorized aligner and never outrank the hit list's k-th hit;
4. long pair: ``align_pair`` SCORE vs ALIGNMENT on an 8,192 x 8,192 pair;
5. the ``gpu`` test lane (tests/test_gpu.py) via ``pytest.main``.

Host-side reference checks run in a pool of CPU worker processes that never
touch the card. Any failed check raises; the last line of a passing run is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GAP_OPEN, GAP_EXTEND = 10, 1
QUERY_LENGTHS = (144, 375, 1000, 5478)
K = 10


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_info() -> str:
    """``name, power.limit`` lines from nvidia-smi (no JAX in this child)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip()


def median_time(fn, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# -- host reference workers (CPU only; never import JAX's GPU backend) ------

def _worker_init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, HERE)


def _oracle(args) -> int:
    q, s, local = args
    from libssa_tpu import matrices, oracle

    fn = oracle.sw_score if local else oracle.nw_score
    return fn(q, s, matrices.builtin("BLOSUM62").scores, GAP_OPEN, GAP_EXTEND)


def _aligner(args) -> int:
    q, s, local = args
    from libssa_tpu import matrices
    from libssa_tpu.oracle import gap_qr
    from libssa_tpu.search.aligner import fill_matrices

    Q, R = gap_qr(GAP_OPEN, GAP_EXTEND)
    H, _, _ = fill_matrices(q, s, matrices.builtin("BLOSUM62").scores, Q, R, local)
    return int(H.max()) if local else int(H[len(q), len(s)])


def cigar_score(q, s, hit, sub, Q, R) -> int:
    """Score of a hit's CIGAR path (one op letter per column)."""
    i, j = hit.q_begin, hit.s_begin
    total, prev = 0, None
    for op in hit.cigar:
        if op == "M":
            total += int(sub[q[i], s[j]])
            i, j = i + 1, j + 1
        else:
            total -= R if op == prev else Q
            if op == "D":
                i += 1
            else:
                j += 1
        prev = op
    check((i, j) == (hit.q_end, hit.s_end), "CIGAR spans the hit's ranges")
    return total


# -- phases -----------------------------------------------------------------

def phase_device(four_cards: bool):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"JAX's first device is a GPU ({devs[0]})")
    if four_cards:
        check(len(devs) >= 4, f"four GPUs visible ({len(devs)})")
    say(f"[device] {devs[0].device_kind} x{len(devs)}; jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devs


def phase_kernel(pool, card: str, rng) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libssa_tpu import matrices
    from libssa_tpu.ops.scoring import make_profile
    from libssa_tpu.search import kernels

    m, B, n = 256, 8192, 512
    padded = matrices.builtin("BLOSUM62").padded()
    q = rng.integers(0, 20, m).astype(np.uint8)
    profile = jnp.asarray(make_profile(q, padded), jnp.int32)
    codes_np = rng.integers(0, 20, (n, B)).astype(np.int8)
    lens_np = rng.integers(1, n + 1, B).astype(np.int32)
    lens_np[:64] = n
    codes_np[np.arange(n)[:, None] >= lens_np[None, :]] = 31
    codes = jnp.asarray(codes_np)[None]
    lens = jnp.asarray(lens_np)[None]
    sample = rng.choice(B, 64, replace=False)
    routes = {
        "triton": ("pallas", False, jnp.int32),
        "scan-take": ("scan", False, jnp.int32),
        "scan-dot": ("scan", True, jnp.float32),
    }
    for local in (True, False):
        mode = "SW" if local else "NW"
        outs = {}
        for name, (route, use_mm, dtype) in routes.items():
            fn = jax.jit(
                lambda c, l, route=route, use_mm=use_mm, dtype=dtype:
                kernels.sweep_groups(
                    route, *kernels.single_query(profile, [(c, l)], m),
                    GAP_OPEN + GAP_EXTEND, GAP_EXTEND, local=local,
                    use_matmul=use_mm, track_range=True, dtype=dtype,
                )[0]
            )
            if local and name == "triton":
                say("[kernel] triton memory_analysis:",
                    fn.lower(codes, lens).compile().memory_analysis())
            outs[name] = [np.asarray(x) for x in fn(codes, lens)]
            dt = median_time(lambda: fn(codes, lens))
            say(f"[kernel] {mode} {name}: median {dt * 1e3:.3f} ms "
                f"({m * B * n / dt / 1e9:.1f} GCUPS padded) on {card}")
        for name in ("scan-take", "scan-dot"):
            for a, b in zip(outs["triton"], outs[name]):
                check(np.array_equal(a, b), f"{mode} triton == {name}, all lanes")
        want = pool.map(
            _oracle,
            [(q, codes_np[: lens_np[b], b].astype(np.uint8), local) for b in sample],
        )
        check(
            np.array_equal(outs["triton"][0][0, sample], np.asarray(want)),
            f"{mode} kernel == int64 oracle on 64 sampled lanes",
        )
        say(f"[kernel] {mode}: kernel == scan (all {B} lanes, both gathers) "
            f"== oracle (64 lanes)")


def write_fasta(path: str, n_seqs: int, seed: int):
    """Seeded protein DB with bench.py's length distribution."""
    import numpy as np

    from libssa_tpu.constants import AA_ALPHABET

    rng = np.random.default_rng(seed)
    lengths = np.clip(
        rng.lognormal(mean=5.7, sigma=0.55, size=n_seqs).astype(int), 50, 2000
    )
    letters = np.frombuffer(AA_ALPHABET[:20].encode(), np.uint8)
    res = letters[rng.integers(0, 20, int(lengths.sum()))].tobytes()
    offs = np.concatenate([[0], np.cumsum(lengths)])
    with open(path, "wb") as f:
        for i in range(n_seqs):
            f.write(b">s%d\n%s\n" % (i, res[offs[i] : offs[i + 1]]))
    return int(lengths.sum())


def load_db(ctx, path: str, n_seqs: int, seed: int):
    t0 = time.perf_counter()
    residues = write_fasta(path, n_seqs, seed)
    t1 = time.perf_counter()
    ctx.init_db_fasta(path)  # native parser + packing + npz cache write
    t2 = time.perf_counter()
    first = ctx.db
    ctx.init_db_fasta(path)  # npz cache read
    t3 = time.perf_counter()
    check(len(ctx.db) == n_seqs and ctx.db.total_residues == residues,
          "init_db_fasta loads every record")
    check(bool((ctx.db.lengths == first.lengths).all()), "cache reload == parse")
    say(f"[search] DB {n_seqs} seqs, {residues} residues: FASTA write "
        f"{t1 - t0:.1f}s, parse+pack+cache {t2 - t1:.1f}s, cache load "
        f"{t3 - t2:.1f}s")


def make_context(symtype_nt_query: bool = False):
    import libssa_tpu.api as api
    from libssa_tpu.constants import Strand, SymType

    ctx = api.SSAContext()
    ctx.init_symbol_translation(
        SymType.NUCLEOTIDE if symtype_nt_query else SymType.AMINOACID,
        Strand.BOTH if symtype_nt_query else Strand.FORWARD, 1, 1,
        db_symtype=SymType.AMINOACID,
    )
    ctx.init_score_matrix("BLOSUM62")
    ctx.init_gap_penalties(GAP_OPEN, GAP_EXTEND)
    return ctx


def hits_of(lst):
    return [(h.seq_id, h.score) for h in lst]


def phase_search(pool, card: str, n_seqs: int, seed: int, workdir: str):
    import numpy as np

    from libssa_tpu import alphabet
    from libssa_tpu.constants import BitWidth, ComputeMode, SymType
    from libssa_tpu.oracle import gap_qr
    from libssa_tpu.search.manager import SearchEngine, SearchParams

    ctx = make_context()
    load_db(ctx, os.path.join(workdir, "db.fas"), n_seqs, seed)
    db = ctx.db
    sub = ctx.matrix.scores
    Q, R = gap_qr(GAP_OPEN, GAP_EXTEND)
    rng = np.random.default_rng(seed + 1)
    qcodes = [rng.integers(0, 20, m).astype(np.uint8) for m in QUERY_LENGTHS]
    queries = [
        ctx.init_sequence_fasta(alphabet.decode(c, SymType.AMINOACID))
        for c in qcodes
    ]
    engine = SearchEngine(db, ctx.matrix, GAP_OPEN, GAP_EXTEND, SearchParams())
    for local in (True, False):
        mode = "SW" if local else "NW"
        align = ctx.sw_align if local else ctx.nw_align
        lists = []
        for qc, query in zip(qcodes, queries):
            got = {}
            for bw in (BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT16):
                t0 = time.perf_counter()
                got[bw] = align(query, k=K, bit_width=bw)
                say(f"[search] {mode} m={len(qc)} {bw.name}: "
                    f"{time.perf_counter() - t0:.2f}s on {card}")
            exact = hits_of(got[BitWidth.EXACT])
            check(len(exact) == K, f"{mode} m={len(qc)} returns {K} hits")
            check(exact == hits_of(got[BitWidth.BIT8]) == hits_of(got[BitWidth.BIT16]),
                  f"{mode} m={len(qc)} EXACT == BIT8 == BIT16 hit lists")
            want = pool.map(_oracle, [(qc, db.sequence(i), local) for i, _ in exact])
            check([s for _, s in exact] == want,
                  f"{mode} m={len(qc)} every hit == int64 oracle")
            t0 = time.perf_counter()
            aligned = align(query, k=K, mode=ComputeMode.ALIGNMENT)
            check(hits_of(aligned) == exact, f"{mode} m={len(qc)} ALIGNMENT hits")
            for h in aligned:
                check(cigar_score(qc, db.sequence(h.seq_id), h, sub, Q, R) == h.score,
                      f"{mode} m={len(qc)} CIGAR of hit {h.seq_id} re-scores")
            say(f"[search] {mode} m={len(qc)} ALIGNMENT: {K} CIGARs re-score "
                f"({time.perf_counter() - t0:.2f}s)")
            sample = np.sort(rng.choice(len(db), 500, replace=False))
            sub_eng = SearchEngine(db.subset(sample), ctx.matrix, GAP_OPEN,
                                   GAP_EXTEND, SearchParams())
            [(s_s, s_i)] = sub_eng.search_many([qc], 500, local)
            eng_scores = dict(zip(sample[s_i].tolist(), s_s.tolist()))
            ref = pool.map(_aligner, [(qc, db.sequence(i), local) for i in sample])
            check([eng_scores[i] for i in sample.tolist()] == ref,
                  f"{mode} m={len(qc)} engine == aligner on 500 sampled subjects")
            kth = (exact[-1][1], -exact[-1][0])
            in_list = {i for i, _ in exact}
            check(all((sc, -i) <= kth for i, sc in zip(sample.tolist(), ref)
                      if i not in in_list),
                  f"{mode} m={len(qc)} no sampled subject outranks the k-th hit")
            lists.append(exact)
            say(f"[search] {mode} m={len(qc)}: hits == oracle; 500 sampled == aligner")
        t0 = time.perf_counter()
        many = engine.search_many(qcodes, K, local)
        check([list(zip(i.tolist(), s.tolist())) for s, i in many] == lists,
              f"{mode} search_many == per-query hit lists")
        say(f"[search] {mode} search_many x{len(qcodes)}: "
            f"{time.perf_counter() - t0:.2f}s on {card}")
        if local:  # the s64 lane's compile dominates; SW covers it
            t0 = time.perf_counter()
            b64 = align(queries[0], k=K, bit_width=BitWidth.BIT64)
            check(hits_of(b64) == lists[0],
                  f"{mode} BIT64 == EXACT (m={QUERY_LENGTHS[0]})")
            say(f"[search] {mode} BIT64 m={QUERY_LENGTHS[0]}: "
                f"{time.perf_counter() - t0:.2f}s (incl. s64 compile) on {card}")
    # Translated search: a nucleotide query's six frames against the
    # protein DB, reduced on device (search_reduced).
    nt = rng.integers(0, 4, 3 * QUERY_LENGTHS[1]).astype(np.uint8)
    frames = [alphabet.translate(nt[f:]) for f in range(3)] + [
        alphabet.translate(alphabet.reverse_complement(nt)[f:]) for f in range(3)
    ]
    t0 = time.perf_counter()
    got = engine.search_reduced(frames, None, K, True)
    check(got is not None, "search_reduced stays in the exact window")
    top_s, _, top_e, top_f = got
    want = pool.map(_oracle, [(frames[f], db.sequence(e), True)
                              for e, f in zip(top_e.tolist(), top_f.tolist())])
    check(len(top_s) == K and top_s.tolist() == want,
          "search_reduced hits == oracle (frame vs entry)")
    say(f"[search] search_reduced 6 frames: {time.perf_counter() - t0:.2f}s; "
        f"hits == oracle")


def phase_long_pair(card: str, seed: int) -> None:
    import numpy as np

    from libssa_tpu import alphabet
    from libssa_tpu.constants import AlignType, ComputeMode, SymType

    ctx = make_context()
    rng = np.random.default_rng(seed + 2)
    q = rng.integers(0, 20, 8192).astype(np.uint8)
    s = q.copy()
    mut = rng.choice(8192, 1500, replace=False)
    s[mut] = rng.integers(0, 20, len(mut))
    query = ctx.init_sequence_fasta(alphabet.decode(q, SymType.AMINOACID))
    subject = alphabet.decode(s, SymType.AMINOACID)
    t0 = time.perf_counter()
    scored = ctx.align_pair(query, subject, AlignType.SW, ComputeMode.SCORE)
    t1 = time.perf_counter()
    aligned = ctx.align_pair(query, subject, AlignType.SW, ComputeMode.ALIGNMENT)
    t2 = time.perf_counter()
    check(scored.score == aligned.score, "long pair SCORE == ALIGNMENT score")
    say(f"[long pair] 8192 x 8192 SW score {scored.score}: SCORE mode "
        f"{t1 - t0:.2f}s (device scan, incl. compile) on {card}; "
        f"ALIGNMENT mode {t2 - t1:.2f}s (host Myers-Miller)")


def phase_gpu_tests() -> None:
    import pytest

    class Counter:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Counter.passed += 1
            elif report.failed:
                Counter.failed += 1
            elif report.skipped:
                Counter.skipped += 1

    os.environ["LIBSSA_TEST_ACCELERATOR"] = "1"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(HERE, "tests", "test_gpu.py")],
        plugins=[Counter()],
    )
    check(rc == 0 and Counter.failed == 0 and Counter.skipped == 0
          and Counter.passed > 0,
          f"gpu test lane (rc={rc}, passed={Counter.passed}, "
          f"failed={Counter.failed}, skipped={Counter.skipped})")
    say(f"[gpu tests] {Counter.passed} passed")


def phase_four_cards(card: str, n_seqs: int, seed: int, workdir: str) -> None:
    import jax
    import numpy as np

    from libssa_tpu import alphabet, matrices
    from libssa_tpu.constants import BitWidth, SymType
    from libssa_tpu.ops.longpair import longpair_score
    from libssa_tpu.parallel.ring import ring_score
    from libssa_tpu.parallel.sharded import ShardedSearchEngine, make_db_mesh
    from libssa_tpu.search.manager import SearchEngine, SearchParams

    ctx = make_context()
    load_db(ctx, os.path.join(workdir, "db.fas"), n_seqs, seed)
    ctx.set_device_count(4)
    mesh = make_db_mesh(4)
    rng = np.random.default_rng(seed + 1)
    qcodes = [rng.integers(0, 20, m).astype(np.uint8) for m in QUERY_LENGTHS[:2]]
    single = SearchEngine(ctx.db, ctx.matrix, GAP_OPEN, GAP_EXTEND, SearchParams())
    sharded = ShardedSearchEngine(ctx.db, ctx.matrix, GAP_OPEN, GAP_EXTEND,
                                  mesh, SearchParams())
    same = lambda a, b: all(
        np.array_equal(x, y) for x, y in zip(a, b)
    ) and len(a) == len(b)
    for local in (True, False):
        mode = "SW" if local else "NW"
        align = ctx.sw_align if local else ctx.nw_align
        query = ctx.init_sequence_fasta(alphabet.decode(qcodes[0], SymType.AMINOACID))
        t0 = time.perf_counter()
        via_api = align(query, k=K)
        want = single.search(qcodes[0], K, local)
        check([(h.seq_id, h.score) for h in via_api]
              == list(zip(want[1].tolist(), want[0].tolist())),
              f"{mode} api on 4 cards == single-device hits")
        check(same(sharded.search(qcodes[0], K, local), want),
              f"{mode} sharded search == single-device")
        many_s = sharded.search_many(qcodes, K, local)
        many_w = single.search_many(qcodes, K, local)
        check(all(same(a, b) for a, b in zip(many_s, many_w)),
              f"{mode} sharded search_many == single-device")
        red_s = sharded.search_reduced(qcodes, None, K, local)
        red_w = single.search_reduced(qcodes, None, K, local)
        check(red_s is not None and same(red_s, red_w),
              f"{mode} sharded search_reduced == single-device")
        if local:  # the s64 lane's compile dominates; SW covers it
            b64_s = sharded.search(qcodes[0], K, local, BitWidth.BIT64)
            check(same(b64_s, want), f"{mode} sharded BIT64 == single-device EXACT")
        say(f"[4 cards] {mode}: search, search_many, search_reduced"
            f"{', BIT64' if local else ''} == single-device "
            f"({time.perf_counter() - t0:.1f}s)")
    check(sharded.requeued_chunks == 0, "no chunk was re-queued")
    padded = matrices.builtin("BLOSUM62").padded()
    q = rng.integers(0, 20, 1000).astype(np.uint8)
    s = rng.integers(0, 20, 2048).astype(np.uint8)
    for local in (True, False):
        t0 = time.perf_counter()
        got = ring_score(q, s, padded, GAP_OPEN, GAP_EXTEND, local=local, mesh=mesh)
        want = longpair_score(q, s, padded, GAP_OPEN, GAP_EXTEND, local=local)
        check(got == want, f"ring_score == longpair_score ({'SW' if local else 'NW'})")
        say(f"[4 cards] ring_score {'SW' if local else 'NW'} 1000 x 2048 over "
            f"{len(jax.devices()[:4])} cards == longpair_score ({got}; "
            f"{time.perf_counter() - t0:.1f}s)")
    say("[4 cards] requeued_chunks == 0")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its comparison")
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--n-seqs", type=int, default=500_000)
    args = ap.parse_args()

    card = card_info()
    devs = phase_device(args.four_cards)
    say(f"[device] nvidia-smi name, power.limit: {card}")
    card = card.splitlines()[0]

    import multiprocessing as mp
    import shutil

    import numpy as np

    workdir = os.path.join(HERE, ".smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        if args.four_cards:
            phase_four_cards(card, args.n_seqs, args.seed, workdir)
        else:
            workers = max(1, min(8, (os.cpu_count() or 2) - 2))
            with mp.get_context("spawn").Pool(workers, _worker_init) as pool:
                phase_kernel(pool, card, np.random.default_rng(args.seed))
                phase_search(pool, card, args.n_seqs, args.seed, workdir)
            phase_long_pair(card, args.seed)
            phase_gpu_tests()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"[device] nvidia-smi name, power.limit: {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
