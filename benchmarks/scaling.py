"""Weak-scaling evidence harness for the sharded engine (VERDICT r1 #5).

Runs the SAME per-device workload at increasing device counts on the
virtual CPU mesh (weak scaling: DB size grows with D, per-device shard
constant) and reports per-stage timings — pack, upload, compute+merge
(one SPMD dispatch measures both; the all_gather merge moves D*k ints and
is not separable from outside), fetch — plus parallel efficiency.

CPU-mesh numbers measure PROGRAM structure (dispatch counts, collective
shapes), not accelerator silicon: virtual devices share one host's cores,
so compute "scaling" here is bounded by host parallelism. The
communication-volume argument for real hardware is printed at the end;
``chip_smoke.py --four-cards`` runs the mesh path on four GPUs.

Run:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python benchmarks/scaling.py [--subjects-per-device 2000] [--queries 8]
"""
import argparse
import os
import sys
import time

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libssa_tpu import matrices
from libssa_tpu.constants import SymType
from libssa_tpu.io.db import SequenceDB
from libssa_tpu.parallel.sharded import ShardedSearchEngine, make_db_mesh
from libssa_tpu.search.manager import SearchParams


def build_db(n, seed=0, minlen=80, maxlen=400):
    rng = np.random.default_rng(seed)
    lens = rng.integers(minlen, maxlen, n)
    seqs = [rng.integers(0, 20, int(l)).astype(np.uint8) for l in lens]
    return SequenceDB.from_sequences(
        [f"s{i}" for i in range(n)], seqs, SymType.AMINOACID
    )


def run_one(D, subjects_per_device, queries, k, reps=2):
    db = build_db(D * subjects_per_device, seed=D)
    mat = matrices.builtin("BLOSUM62")
    params = SearchParams(batch_size=max(256, subjects_per_device // 2))
    mesh = make_db_mesh(D)
    eng = ShardedSearchEngine(db, mat, 10, 1, mesh, params)

    t0 = time.perf_counter()
    eng._chunk_plan()
    t_pack = time.perf_counter() - t0

    t0 = time.perf_counter()
    eng._device_groups()
    jax.block_until_ready(
        [v[0] for v in eng._device_plan.values()]
    )
    t_upload = time.perf_counter() - t0

    # warm (compile)
    eng.search_many(queries, k)
    t_best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = eng.search_many(queries, k)
        t_best = min(t_best, time.perf_counter() - t0)
    cells = sum(len(q) for q in queries) * db.total_residues
    return {
        "D": D,
        "pack_s": t_pack,
        "upload_s": t_upload,
        "sweep_s": t_best,
        "gcups": cells / t_best / 1e9,
        "out": out,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subjects-per-device", type=int, default=600)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--devices", type=str, default="1,2,4,8")
    args = ap.parse_args()

    rng = np.random.default_rng(99)
    queries = [
        rng.integers(0, 20, int(rng.integers(120, 250))).astype(np.uint8)
        for _ in range(args.queries)
    ]
    dev_counts = [int(d) for d in args.devices.split(",")]
    avail = len(jax.devices())
    dev_counts = [d for d in dev_counts if d <= avail]

    print(f"platform={jax.devices()[0].platform} devices={avail} "
          f"weak scaling: {args.subjects_per_device} subjects/device, "
          f"{args.queries} queries, k={args.k}")
    print(f"{'D':>3} {'pack_s':>8} {'upload_s':>9} {'sweep_s':>8} "
          f"{'GCUPS':>8} {'eff%':>6} {'hostx':>6}")
    base = None
    for D in dev_counts:
        r = run_one(D, args.subjects_per_device, queries, args.k)
        # Weak scaling: ideal sweep time is CONSTANT as D grows; the work
        # per device is fixed and the merge volume is D*k ints. On the
        # VIRTUAL mesh all devices share one host's cores, so total work
        # grows with D on fixed silicon and eff% is a host artifact —
        # 'hostx' (work-normalized speedup, base*D/sweep) shows how much
        # of the D-fold work the host absorbed. eff% is the number that
        # matters on real cards.
        if base is None:
            base = r["sweep_s"]
        eff = 100.0 * base / r["sweep_s"]
        hostx = base * D / r["sweep_s"]
        print(f"{D:>3} {r['pack_s']:>8.3f} {r['upload_s']:>9.3f} "
              f"{r['sweep_s']:>8.3f} {r['gcups']:>8.2f} {eff:>6.1f} "
              f"{hostx:>6.2f}")

    print("""
Communication-volume argument for real interconnects (NVLink):
  per (query, step) pair the only cross-device traffic is the top-k merge
  all_gather of (k,) int32 scores+ids per device = D*k*8 bytes (e.g.
  4 devices * k=10 * 8 B = 320 B) + one psum scalar, against a compute
  of B*m*n_pad DP cells per device per step (~10^8-10^9). At hundreds of
  GB/s the merge is sub-microsecond next to a multi-ms sweep:
  weak-scaling efficiency on hardware is gated by per-step stragglers
  (padded-length variance across shards), held down by strided sharding.
""")


if __name__ == "__main__":
    main()
