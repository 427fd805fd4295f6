"""Multi-device sharded search tests on the virtual 8-device CPU mesh.

SURVEY.md §4: "multi-host logic tested on a single host with jax's
multi-device simulation so the collective top-k merge is testable without a
pod." The contract: sharded results are IDENTICAL to the single-device
engine — same scores, same hit ids, same ordering.
"""
import jax
import numpy as np
import pytest

from libssa_tpu import matrices
from libssa_tpu.constants import BitWidth, SymType
from libssa_tpu.io.db import SequenceDB
from libssa_tpu.parallel.sharded import ShardedSearchEngine, make_db_mesh
from libssa_tpu.search.manager import SearchEngine, SearchParams

B62 = matrices.builtin("BLOSUM62")

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device (virtual CPU) mesh"
)


def _db(n, seed=0, minlen=4, maxlen=60):
    rng = np.random.default_rng(seed)
    seqs = [
        rng.integers(0, 20, int(rng.integers(minlen, maxlen))).astype(np.uint8)
        for _ in range(n)
    ]
    return SequenceDB.from_sequences(
        [f"s{i}" for i in range(n)], seqs, SymType.AMINOACID
    )


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_sharded_matches_single_device(n_devices, local):
    db = _db(50, seed=1)
    rng = np.random.default_rng(2)
    q = rng.integers(0, 20, 21).astype(np.uint8)
    params = SearchParams(batch_size=16)
    single = SearchEngine(db, B62, 10, 1, params)
    mesh = make_db_mesh(n_devices)
    sharded = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
    s1, i1 = single.search(q, k=9, local=local)
    s2, i2 = sharded.search(q, k=9, local=local)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(i1, i2)


def test_sharded_ladder_with_overflow():
    """BIT8 start: overflowing self-hit must be rescored and still rank 1."""
    # Subjects >= 70 residues: the self-hit of subject 4 scores at least
    # 70 * 4 (min BLOSUM62 diagonal) = 280 > 255 -> guaranteed 8-bit overflow.
    db = _db(30, seed=3, minlen=70, maxlen=90)
    q = db.sequence(4).copy()
    mesh = make_db_mesh(4)
    params = SearchParams(batch_size=8)
    sharded = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
    single = SearchEngine(db, B62, 10, 1, params)
    s1, i1 = single.search(q, k=5, local=True, bit_width=BitWidth.BIT8)
    s2, i2 = sharded.search(q, k=5, local=True, bit_width=BitWidth.BIT8)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(i1, i2)
    assert i2[0] == 4 and s2[0] > 255  # the engineered overflow hit


def test_sharded_ladder_elides_redundant_rescore():
    """Emulated-width flags alone must NOT trigger the fallback rescore
    when the f32 window bound holds (the sweep scores are already exact).
    NW makes this acute: the pallas kernel's static per-lane lo bound
    flags nearly every lane at narrow widths — pre-fix, a sharded NW BIT8
    search rescored the whole DB on the single-device engine."""
    from libssa_tpu.search.manager import SearchStats

    db = _db(30, seed=3, minlen=70, maxlen=90)
    q = db.sequence(4).copy()
    mesh = make_db_mesh(4)
    params = SearchParams(batch_size=8)
    for local in (True, False):
        sharded = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
        calls = []
        orig = db.subset
        db.subset = lambda ids: (calls.append(len(ids)), orig(ids))[1]
        try:
            stats = SearchStats()
            s2, i2 = sharded.search(
                q, k=5, local=local, bit_width=BitWidth.BIT8, stats=stats
            )
        finally:
            db.subset = orig
        single = SearchEngine(db, B62, 10, 1, params)
        s1, i1 = single.search(q, k=5, local=local, bit_width=BitWidth.BIT8)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(i1, i2)
        assert stats.rescored, "rung stats must still record the flags"
        assert not calls, f"local={local}: fallback rescore ran ({calls})"

    # A genuine window risk must still run the real rescue, bit-identically.
    sharded = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
    sharded._fallback._window_risk = lambda m: True
    s3, i3 = sharded.search(q, k=5, local=True, bit_width=BitWidth.BIT8)
    single = SearchEngine(db, B62, 10, 1, params)
    s1, i1 = single.search(q, k=5, local=True, bit_width=BitWidth.BIT8)
    np.testing.assert_array_equal(s1, s3)
    np.testing.assert_array_equal(i1, i3)


def test_uneven_shard_sizes():
    """DB size not divisible by device count: padding lanes must not leak."""
    db = _db(13, seed=5)
    rng = np.random.default_rng(6)
    q = rng.integers(0, 20, 15).astype(np.uint8)
    mesh = make_db_mesh(8)
    sharded = ShardedSearchEngine(db, B62, 10, 1, mesh, SearchParams(batch_size=8))
    single = SearchEngine(db, B62, 10, 1, SearchParams(batch_size=8))
    s1, i1 = single.search(q, k=13, local=True)
    s2, i2 = sharded.search(q, k=13, local=True)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(i1, i2)
    assert (i2 >= 0).all() and (i2 < 13).all()


def test_graft_entry_dryrun():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    s, hi, lo = jax.jit(fn)(*args)
    assert s.shape == (128,)
    ge.dryrun_multichip(8)


def test_fault_injection_requeues_chunk():
    """A failing SPMD chunk step must be re-queued, results unchanged
    (SURVEY.md §5: shards are independently restartable)."""
    db = _db(40, seed=8)
    rng = np.random.default_rng(9)
    q = rng.integers(0, 20, 18).astype(np.uint8)
    params = SearchParams(batch_size=16)
    mesh = make_db_mesh(4)

    clean = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
    s_ok, i_ok = clean.search(q, k=8, local=True)

    faulty = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
    def boom(step_idx):
        if step_idx == 0:
            raise RuntimeError("injected device failure")
    faulty.fault_injector = boom
    s2, i2 = faulty.search(q, k=8, local=True)
    assert faulty.requeued_chunks == 1
    np.testing.assert_array_equal(s_ok, s2)
    np.testing.assert_array_equal(i_ok, i2)


def test_k_exceeds_per_device_lanes():
    """k larger than a step's per-device lane count (soak-caught): the
    per-device top lists are then min(k, lanes) wide and the decode must
    not splice ids into scores."""
    db = _db(81, seed=11)
    rng = np.random.default_rng(12)
    q = rng.integers(0, 20, 30).astype(np.uint8)
    params = SearchParams(batch_size=8)  # 8 lanes/device < k=10
    single = SearchEngine(db, B62, 10, 1, params)
    sharded = ShardedSearchEngine(db, B62, 10, 1, make_db_mesh(1), params)
    s1, i1 = single.search(q, k=10, local=True)
    s2, i2 = sharded.search(q, k=10, local=True)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_search_many_matches_single_device(n_devices, local):
    """Multi-query sharded sweep == single-device search_many (r2)."""
    db = _db(60, seed=11)
    rng = np.random.default_rng(12)
    # Mixed query lengths on purpose: heights 32 and 64 exercise grouping.
    queries = [
        rng.integers(0, 20, int(n)).astype(np.uint8)
        for n in (21, 30, 40, 33)
    ]
    params = SearchParams(batch_size=16)
    single = SearchEngine(db, B62, 10, 1, params)
    sharded = ShardedSearchEngine(
        db, B62, 10, 1, make_db_mesh(n_devices), params
    )
    want = single.search_many(queries, k=7, local=local)
    got = sharded.search_many(queries, k=7, local=local)
    assert len(got) == len(want)
    for (ws, wi), (gs, gi) in zip(want, got):
        np.testing.assert_array_equal(ws, gs)
        np.testing.assert_array_equal(wi, gi)


def test_sharded_search_many_k_exceeds_db():
    db = _db(5, seed=13)
    rng = np.random.default_rng(14)
    queries = [rng.integers(0, 20, 15).astype(np.uint8) for _ in range(2)]
    params = SearchParams(batch_size=8)
    sharded = ShardedSearchEngine(db, B62, 10, 1, make_db_mesh(4), params)
    single = SearchEngine(db, B62, 10, 1, params)
    got = sharded.search_many(queries, k=20, local=True)
    want = single.search_many(queries, k=20, local=True)
    for (ws, wi), (gs, gi) in zip(want, got):
        np.testing.assert_array_equal(ws, gs)
        np.testing.assert_array_equal(wi, gi)


def test_sharded_search_reduced_matches_single_device():
    """Sharded translated/frame-fanout search == single-device (r2)."""
    import numpy as np

    from libssa_tpu import alphabet
    from libssa_tpu.constants import SymType
    from libssa_tpu.io.db import SequenceDB

    rng = np.random.default_rng(23)
    nt_seqs = [
        rng.integers(0, 4, int(n)).astype(np.uint8)
        for n in rng.integers(12, 120, size=25)
    ]
    ntdb = SequenceDB.from_sequences(
        [f"nt{i}" for i in range(len(nt_seqs))], nt_seqs, SymType.NUCLEOTIDE
    )
    tdb, orig, labels = ntdb.translated(1)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    params = SearchParams(batch_size=16)
    single = SearchEngine(tdb, B62, 10, 1, params)
    want = single.search_reduced(frames, orig, 6, True)
    for D in (2, 8):
        sharded = ShardedSearchEngine(tdb, B62, 10, 1, make_db_mesh(D), params)
        got = sharded.search_reduced(frames, orig, 6, True)
        assert got is not None and want is not None
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # identity grouping (plain multi-frame query) also agrees
    want2 = single.search_reduced(frames, None, 6, True)
    got2 = ShardedSearchEngine(
        tdb, B62, 10, 1, make_db_mesh(4), params
    ).search_reduced(frames, None, 6, True)
    for a, b in zip(got2, want2):
        np.testing.assert_array_equal(a, b)


def test_params_mutation_invalidates_plan():
    """In-place params mutation must rebuild the device plan, not serve
    stale stacks (VERDICT r2 weak #7)."""
    db = _db(40, seed=21)
    rng = np.random.default_rng(22)
    q = rng.integers(0, 20, 18).astype(np.uint8)
    eng = ShardedSearchEngine(
        db, B62, 10, 1, make_db_mesh(4), SearchParams(batch_size=16)
    )
    s1, i1 = eng.search(q, k=8, local=True)
    assert eng._plan_key == (16, 64)
    eng.params.batch_size = 8  # in-place mutation
    s2, i2 = eng.search(q, k=8, local=True)
    assert eng._plan_key == (8, 64)  # plan rebuilt from the new value
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(i1, i2)


def test_fault_injection_requeues_search_many():
    """A failing SPMD group in search_many must be re-queued on the
    fallback engine, results bit-identical (VERDICT r2 missing #5)."""
    db = _db(50, seed=31)
    rng = np.random.default_rng(32)
    queries = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (20, 35)]
    params = SearchParams(batch_size=16)
    mesh = make_db_mesh(4)

    clean = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
    want = clean.search_many(queries, k=8, local=True)

    faulty = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
    def boom(group_idx):
        if group_idx == 0:
            raise RuntimeError("injected device failure")
    faulty.fault_injector = boom
    got = faulty.search_many(queries, k=8, local=True)
    assert faulty.requeued_chunks > 0
    for (ws, wi), (gs, gi) in zip(want, got):
        np.testing.assert_array_equal(ws, gs)
        np.testing.assert_array_equal(wi, gi)


def test_fault_injection_requeues_search_reduced():
    """Same for the translated/frame-fanout path."""
    rng = np.random.default_rng(41)
    nt_seqs = [
        rng.integers(0, 4, int(n)).astype(np.uint8)
        for n in rng.integers(12, 120, size=25)
    ]
    ntdb = SequenceDB.from_sequences(
        [f"nt{i}" for i in range(len(nt_seqs))], nt_seqs, SymType.NUCLEOTIDE
    )
    tdb, orig, _ = ntdb.translated(1)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    params = SearchParams(batch_size=16)
    mesh = make_db_mesh(4)

    clean = ShardedSearchEngine(tdb, B62, 10, 1, mesh, params)
    want = clean.search_reduced(frames, orig, 6, True)

    faulty = ShardedSearchEngine(tdb, B62, 10, 1, mesh, params)
    def boom(group_idx):
        if group_idx == 0:
            raise RuntimeError("injected device failure")
    faulty.fault_injector = boom
    got = faulty.search_reduced(frames, orig, 6, True)
    assert faulty.requeued_chunks > 0
    assert got is not None and want is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_reduced_overflow_fallback(monkeypatch):
    """Force an f32-window escape on the sharded translated path: the
    engine must return None and the api-level fallback (single-device
    exact host path) must produce the same hits as an untouched context
    (VERDICT r2 weak #6)."""
    from libssa_tpu.search import manager as M

    rng = np.random.default_rng(51)
    nt_seqs = [
        rng.integers(0, 4, int(n)).astype(np.uint8)
        for n in rng.integers(20, 90, size=15)
    ]
    ntdb = SequenceDB.from_sequences(
        [f"nt{i}" for i in range(len(nt_seqs))], nt_seqs, SymType.NUCLEOTIDE
    )
    tdb, orig, _ = ntdb.translated(1)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    params = SearchParams(batch_size=16)

    # Reference result with the real window (no overflow).
    single = SearchEngine(tdb, B62, 10, 1, params)
    want = single.search_reduced(frames, orig, 6, True)

    # Shrink the window: every lane now "overflows".
    monkeypatch.setattr(M, "F32_WINDOW", 1)
    sharded = ShardedSearchEngine(tdb, B62, 10, 1, make_db_mesh(4), params)
    assert sharded.search_reduced(frames, orig, 6, True) is None

    # The api-layer fallback path: exact host reduction, same semantics.
    eng = SearchEngine(tdb, B62, 10, 1, SearchParams(batch_size=16, dtype="int32"))
    got = eng.search_reduced(frames, orig, 6, True)
    assert got is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_reduced_overflow_warning(monkeypatch, capsys):
    """The mesh->single-device drop on an f32-window escape must NOT be
    silent: a WARNING-level log fires (VERDICT r3 weak #5)."""
    from libssa_tpu.search import manager as M

    rng = np.random.default_rng(52)
    db = _db(12, seed=52)
    frames = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (14, 21)]
    params = SearchParams(batch_size=16)
    monkeypatch.setattr(M, "F32_WINDOW", 1)
    sharded = ShardedSearchEngine(db, B62, 10, 1, make_db_mesh(4), params)
    assert sharded.search_reduced(frames, None, 5, True) is None
    err = capsys.readouterr().err
    assert "sharded search_reduced" in err and "SINGLE-device" in err


def test_sharded_many_overflow_warning(monkeypatch, capsys):
    """search_many's per-query mesh->single-device fallback logs too."""
    from libssa_tpu.search import manager as M

    rng = np.random.default_rng(53)
    db = _db(12, seed=53)
    queries = [rng.integers(0, 20, 18).astype(np.uint8) for _ in range(2)]
    params = SearchParams(batch_size=16)
    single = SearchEngine(db, B62, 10, 1, params)
    want = single.search_many(queries, 5, True)
    monkeypatch.setattr(M, "F32_WINDOW", 1)
    sharded = ShardedSearchEngine(db, B62, 10, 1, make_db_mesh(4), params)
    got = sharded.search_many(queries, 5, True)
    err = capsys.readouterr().err
    assert "sharded search_many" in err and "SINGLE-device" in err
    for (gs, gi), (ws, wi) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gi, wi)


def test_sharded_dispatch_counts():
    """Mesh paths count round trips like the single-device ladder does:
    ONE dispatch covers every shape group of a sweep, fetches batched as
    documented."""
    from libssa_tpu.search.manager import SearchStats

    db = _db(60, seed=9, minlen=4, maxlen=200)
    rng = np.random.default_rng(10)
    q = rng.integers(0, 20, 24).astype(np.uint8)
    params = SearchParams(batch_size=16)
    mesh = make_db_mesh(4)
    eng = ShardedSearchEngine(db, B62, 10, 1, mesh, params)
    n_groups = len(eng._device_groups())
    assert n_groups >= 2, "test DB must span several chunk shapes"

    st = SearchStats()
    eng.search(q, 5, stats=st)
    # EXACT search still tracks the f32 window -> tops fetch + flags fetch.
    assert st.dispatches == 1
    assert st.fetches == 2

    q2 = rng.integers(0, 20, 40).astype(np.uint8)  # different 32-bucket
    st = SearchStats()
    eng.search_many([q, q2], 5, stats=st)
    # Two height groups, each one dispatch over all shape groups and ONE
    # fetch.
    assert st.dispatches == 2
    assert st.fetches == 2

    st = SearchStats()
    eng.search_reduced([q, q[:20]], None, 5, stats=st)
    # One dispatch + one fetch for all shape groups (frames ride inside).
    assert st.dispatches == 1
    assert st.fetches == 1


def test_sharded_fanout_rung_stats():
    """Narrow bit widths report FAITHFUL rescore rung statistics on the
    mesh fan-out paths, identical to the single-device engine's counts,
    with hit lists bit-identical to EXACT (VERDICT r3 missing #2)."""
    from libssa_tpu.search.manager import SearchStats

    rng = np.random.default_rng(11)
    db = _db(30, seed=11)
    # Plant a 70-residue self-hit: >= 70 * 4 (min BLOSUM62 diagonal) = 280
    # > 255 -> a real 8-bit window escape.
    q = rng.integers(0, 20, 70).astype(np.uint8)
    seqs = [db.sequence(i) for i in range(len(db))] + [q.copy()]
    db = SequenceDB.from_sequences(
        [f"s{i}" for i in range(len(seqs))], seqs, SymType.AMINOACID
    )
    params = SearchParams(batch_size=16)
    single = SearchEngine(db, B62, 10, 1, params)
    sharded = ShardedSearchEngine(db, B62, 10, 1, make_db_mesh(4), params)

    for bw in (BitWidth.BIT8, BitWidth.BIT16):
        st_s, st_m = SearchStats(), SearchStats()
        want = single.search_many([q], 6, True, st_s, bw)
        got = sharded.search_many([q], 6, True, st_m, bw)
        np.testing.assert_array_equal(got[0][0], want[0][0])
        np.testing.assert_array_equal(got[0][1], want[0][1])
        assert st_m.rescored == st_s.rescored
        exact = sharded.search_many([q], 6, True)
        np.testing.assert_array_equal(got[0][0], exact[0][0])
        np.testing.assert_array_equal(got[0][1], exact[0][1])

        st_s, st_m = SearchStats(), SearchStats()
        want_r = single.search_reduced([q], None, 6, True, st_s, bw)
        got_r = sharded.search_reduced([q], None, 6, True, st_m, bw)
        for a, b in zip(got_r, want_r):
            np.testing.assert_array_equal(a, b)
        assert st_m.rescored == st_s.rescored
    # The 8-bit window genuinely overflowed; the 16-bit one did not.
    st8 = SearchStats()
    single.search_many([q], 6, True, st8, BitWidth.BIT8)
    assert st8.rescored.get("limit>255/pairs", 0) >= 1
    st16 = SearchStats()
    single.search_many([q], 6, True, st16, BitWidth.BIT16)
    assert not st16.rescored


def test_sharded_k_beyond_candidates():
    """k past the real candidate count must not surface padding sentinels.

    Review-caught: per-device top lists pad with (NEG_SCORE, INVALID_ID
    = 2**31-1); the POSITIVE sentinel id passed host_topk's id>=0 filter,
    so hits beyond the DB size were garbage rows (and api._align crashed
    indexing headers with 2**31-1). Must match the single-device engine:
    exactly len(db) real hits, no more."""
    db = _db(5, seed=60)
    rng = np.random.default_rng(61)
    q = rng.integers(0, 20, 18).astype(np.uint8)
    params = SearchParams(batch_size=16)
    single = SearchEngine(db, B62, 10, 1, params)
    sharded = ShardedSearchEngine(db, B62, 10, 1, make_db_mesh(4), params)
    s1, i1 = single.search(q, k=12, local=True)
    s2, i2 = sharded.search(q, k=12, local=True)
    assert len(s2) == len(db) and len(i2) == len(db)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(i1, i2)
    assert (i2 < len(db)).all() and (i2 >= 0).all()
