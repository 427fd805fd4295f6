"""Benchmark: SW affine-gap BLOSUM62 database search on one GPU.

Prints two JSON lines: the database-sweep kernel at one chunk shape
(m=256, B=8192, n=512), then the flagship end to end (100 queries x 500k
subjects through ``SearchEngine.search_many``). Every line names the JAX
platform, device kind and count, and the card's name and power limit
(``nvidia-smi``). Exits nonzero without a GPU and when any line fails.

``vs_baseline`` normalizes against the ~100 GCUPS class of the reference's
algorithm family on multi-core x86 (SWIPE lineage, PAPERS.md); the
reference publishes no number of its own (BASELINE.md).

Run: ``python bench.py``
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np

BASELINE_GCUPS = 100.0  # SWIPE-class multi-core x86, see PAPERS.md


def card() -> str:
    """``name, power.limit`` of the card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_fields() -> dict:
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "card": card(),
    }


def median_seconds(fn, reps: int = 5) -> float:
    """Median wall time of ``fn()`` to ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def kernel_line(fields: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from libssa_tpu import matrices
    from libssa_tpu.ops.scoring import make_profile
    from libssa_tpu.search import kernels

    rng = np.random.default_rng(0)
    padded = matrices.builtin("BLOSUM62").padded()
    m, B, n = 256, 8192, 512
    q = rng.integers(0, 20, m).astype(np.uint8)
    profile = jnp.asarray(make_profile(q, padded), jnp.int32)
    codes = jnp.asarray(rng.integers(0, 20, (1, n, B)), jnp.int8)
    lengths = jnp.full((1, B), n, jnp.int32)
    route = kernels.route()
    sweep = jax.jit(
        lambda c, l: kernels.sweep_groups(
            route, *kernels.single_query(profile, [(c, l)], m), 11, 1,
            local=True, use_matmul=False, track_range=True, dtype=jnp.int32,
        )
    )
    dt = median_seconds(lambda: sweep(codes, lengths))
    gcups = m * B * n / dt / 1e9
    return {
        "metric": "sweep kernel GCUPS (SW affine, BLOSUM62, m=256 B=8192 n=512)",
        "value": gcups,
        "unit": "GCUPS",
        "vs_baseline": gcups / BASELINE_GCUPS,
        "route": route,
        **fields,
    }


def flagship_line(fields: dict, n_queries=100, n_seqs=500_000) -> dict:
    """100 x 500k SW search end to end (warm)."""
    from libssa_tpu import matrices
    from libssa_tpu.constants import SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.search.manager import SearchEngine, SearchStats

    rng = np.random.default_rng(99)
    lengths = np.clip(
        rng.lognormal(mean=5.7, sigma=0.55, size=n_seqs).astype(int), 50, 2000
    )
    seqs = [rng.integers(0, 20, L).astype(np.uint8) for L in lengths]
    db = SequenceDB.from_sequences(
        [f"synth{i}" for i in range(n_seqs)], seqs, SymType.AMINOACID
    )
    eng = SearchEngine(db, matrices.builtin("BLOSUM62"), 11, 1)
    qrng = np.random.default_rng(7)
    queries = [qrng.integers(0, 20, 256).astype(np.uint8) for _ in range(n_queries)]
    eng.search_many(queries, 10, local=True)  # pack + upload + compile
    stats = SearchStats()
    eng.search_many(queries, 10, local=True, stats=stats)
    rate = stats.subjects / stats.seconds
    return {
        "metric": f"flagship e2e ({n_queries}q x {n_seqs} subjects)",
        "value": rate,
        "unit": "q*subj/s",
        "vs_baseline": stats.gcups / BASELINE_GCUPS,
        "gcups_e2e": stats.gcups,
        **fields,
    }


def main() -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()}", file=sys.stderr)
        return 1
    fields = device_fields()
    print(json.dumps(kernel_line(fields)), flush=True)
    print(json.dumps(flagship_line(fields)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
