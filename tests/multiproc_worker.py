"""Worker body for the 2-process multi-host regression test.

Launched (twice) by tests/test_multiproc.py with
``python multiproc_worker.py <process_id> <num_processes> <port>``.
Each process owns 2 virtual CPU devices; ``jax.distributed.initialize``
(gloo) joins them into one 4-device global mesh — the same program shape
a real multi-host job takes (nothing distributed had executed across
process boundaries before this test).

Every assertion runs in BOTH processes: the sharded engine's results must
be bit-identical to the per-process single-device engine on
``search`` (SW + NW + BIT8 ladder), ``search_many`` (mixed heights), and
``search_reduced`` (translated DB). Prints MULTIPROC_OK on success.
"""
import os
import sys


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.device_count() == 2 * nproc, jax.devices()
    assert jax.local_device_count() == 2

    import numpy as np

    from libssa_tpu import matrices
    from libssa_tpu.constants import BitWidth, SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.parallel.sharded import ShardedSearchEngine, make_db_mesh
    from libssa_tpu.search.manager import SearchEngine, SearchParams

    B62 = matrices.builtin("BLOSUM62")
    rng = np.random.default_rng(101)  # identical stream in every process
    seqs = [
        rng.integers(0, 20, int(rng.integers(5, 70))).astype(np.uint8)
        for _ in range(60)
    ]
    db = SequenceDB.from_sequences(
        [f"s{i}" for i in range(60)], seqs, SymType.AMINOACID
    )
    params = SearchParams(batch_size=16)
    single = SearchEngine(db, B62, 10, 1, params)  # per-process oracle
    mesh = make_db_mesh()  # spans both processes' devices
    assert not jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("d")
    ).is_fully_addressable, "mesh must cross the process boundary"
    sharded = ShardedSearchEngine(db, B62, 10, 1, mesh, params)

    q = rng.integers(0, 20, 23).astype(np.uint8)
    for local in (True, False):
        s1, i1 = single.search(q, k=9, local=local)
        s2, i2 = sharded.search(q, k=9, local=local)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(i1, i2)

    # BIT8 ladder with a guaranteed overflow (70+-residue self-hit > 255).
    long_seqs = [
        rng.integers(0, 20, int(rng.integers(70, 90))).astype(np.uint8)
        for _ in range(12)
    ]
    ldb = SequenceDB.from_sequences(
        [f"l{i}" for i in range(12)], long_seqs, SymType.AMINOACID
    )
    lq = ldb.sequence(4).copy()
    lsingle = SearchEngine(ldb, B62, 10, 1, params)
    lsharded = ShardedSearchEngine(ldb, B62, 10, 1, mesh, params)
    s1, i1 = lsingle.search(lq, k=5, local=True, bit_width=BitWidth.BIT8)
    s2, i2 = lsharded.search(lq, k=5, local=True, bit_width=BitWidth.BIT8)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(i1, i2)
    assert i2[0] == 4 and s2[0] > 255

    # Multi-query sweep, mixed profile heights.
    queries = [
        rng.integers(0, 20, int(n)).astype(np.uint8) for n in (21, 40, 33)
    ]
    want = single.search_many(queries, k=7, local=True)
    got = sharded.search_many(queries, k=7, local=True)
    for (ws, wi), (gs, gi) in zip(want, got):
        np.testing.assert_array_equal(ws, gs)
        np.testing.assert_array_equal(wi, gi)

    # Translated / frame-fanout search over the mesh.
    from libssa_tpu import alphabet  # noqa: F401  (six-frame machinery)

    nt_seqs = [
        rng.integers(0, 4, int(n)).astype(np.uint8)
        for n in rng.integers(12, 120, size=20)
    ]
    ntdb = SequenceDB.from_sequences(
        [f"nt{i}" for i in range(len(nt_seqs))], nt_seqs, SymType.NUCLEOTIDE
    )
    tdb, orig, _labels = ntdb.translated(1)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    tsingle = SearchEngine(tdb, B62, 10, 1, params)
    tsharded = ShardedSearchEngine(tdb, B62, 10, 1, mesh, params)
    wantr = tsingle.search_reduced(frames, orig, 6, True)
    gotr = tsharded.search_reduced(frames, orig, 6, True)
    assert wantr is not None and gotr is not None
    for a, b in zip(gotr, wantr):
        np.testing.assert_array_equal(a, b)

    print(f"[{pid}] MULTIPROC_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
