"""5M-sequence single-chip DB sweep (round 5; VERDICT r4 next-round #4).

One order of magnitude past the 500k flagship: a UniRef-scale synthetic
protein DB (~1.6 G residues packed, >= 1.5 GB) built, packed, uploaded
ONCE, then swept warm with the fused multi-query top-k path. Phases are
timed separately because they are different costs:

  - synth:   excluded (not a framework cost) — the packed arrays are
             generated directly (one RNG call), not via 5M Python lists.
  - pack:    grouped_stacks — the bucket-ladder plan + vectorized pack
             (the r4 _windows vectorization and _pack gather were built
             for this scale).
  - upload:  the one-time device-resident stack upload.
  - compile: first sweep (persistently cached across runs).
  - warm:    the steady-state metric — q*subj/s and GCUPS.

Usage: /opt/venv/bin/python benchmarks/scale5m.py [--n-seqs N] [--queries Q]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n_seqs = 5_000_000
    n_queries = 10
    args = sys.argv[1:]
    if "--n-seqs" in args:
        n_seqs = int(args[args.index("--n-seqs") + 1])
    if "--queries" in args:
        n_queries = int(args[args.index("--queries") + 1])

    from libssa_tpu import matrices
    from libssa_tpu.constants import SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.search.manager import SearchEngine, SearchStats
    from libssa_tpu.util.jaxcache import enable_compilation_cache

    enable_compilation_cache()

    rng = np.random.default_rng(99)
    t0 = time.perf_counter()
    # Same length law as the flagship e2e (bench.py): lognormal Swiss-Prot
    # shape, clipped. Packed arrays built directly — a 5M-element Python
    # list of per-sequence arrays costs minutes on this 1-core host and
    # models nothing real (FASTA ingest has its own mmap C++ path).
    lengths = np.clip(
        rng.lognormal(mean=5.7, sigma=0.55, size=n_seqs).astype(np.int64),
        50,
        2000,
    ).astype(np.int32)
    offsets = np.zeros(n_seqs, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    total = int(lengths.sum())
    codes = rng.integers(0, 20, total, dtype=np.uint8)
    headers = [f"s{i}" for i in range(n_seqs)]
    db = SequenceDB(codes, offsets, lengths, headers, SymType.AMINOACID)
    t_synth = time.perf_counter() - t0
    print(
        f"synth: {n_seqs} seqs, {total/1e9:.2f} G residues "
        f"({total/2**30:.2f} GiB packed), {t_synth:.1f} s",
        flush=True,
    )

    t0 = time.perf_counter()
    grouped = db.grouped_stacks(8192, 64)
    t_pack = time.perf_counter() - t0
    n_groups = len(grouped)
    n_chunks = sum(c.shape[0] for c, _, _ in grouped)
    padded = sum(c.shape[0] * c.shape[1] * c.shape[2] for c, _, _ in grouped)
    print(
        f"pack: {t_pack:.1f} s -> {n_groups} shape groups, {n_chunks} "
        f"chunks, fill {total/padded:.1%}",
        flush=True,
    )

    eng = SearchEngine(db, matrices.builtin("BLOSUM62"), 11, 1)
    t0 = time.perf_counter()
    _, dev_stacks = eng._stacks_on_device(db, eng.params.batch_size)
    # Fence: the upload is async; touch one element per group.
    for c, _, _ in dev_stacks:
        np.asarray(c[0, 0, 0])
    # The engine packs its own stacks (cache keyed on params), so this
    # window re-ran the pack; subtract the measured pack share to report
    # transfer alone.
    t_upload = max(time.perf_counter() - t0 - t_pack, 0.0)
    print(f"upload: {t_upload:.1f} s ({padded/2**30:.2f} GiB padded)", flush=True)

    qrng = np.random.default_rng(7)
    queries = [
        qrng.integers(0, 20, 256).astype(np.uint8) for _ in range(n_queries)
    ]
    t0 = time.perf_counter()
    eng.search_many(queries, 10, local=True)
    t_compile = time.perf_counter() - t0
    print(f"first sweep (compile + run): {t_compile:.1f} s", flush=True)

    stats = SearchStats()
    eng.search_many(queries, 10, local=True, stats=stats)
    rate = stats.subjects / stats.seconds
    print(
        json.dumps(
            {
                "metric": f"scale e2e ({n_queries}q x {n_seqs} subjects)",
                "value": round(rate, 0),
                "unit": "q*subj/s",
                "gcups_e2e": round(stats.gcups, 2),
                "pack_s": round(t_pack, 1),
                "upload_s": round(t_upload, 1),
                "warm_sweep_s": round(stats.seconds, 1),
                "dispatches": stats.dispatches,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
