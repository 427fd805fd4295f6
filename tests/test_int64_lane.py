"""The TRUE 64-bit device lane (round 4).

SURVEY.md §2 P4 ``[DRIVER]``: the reference keeps a 64-bit rung even
where 32-bit arithmetic would suffice. Rounds 1-3 mapped BIT64 to the
exact-int32 device pass with the int64 NumPy oracle out of band
(PARITY.md documented the mapping); round 4 makes the lane real —
``manager._rungs`` terminates every escape ladder in a device int64
pass, and ``BitWidth.BIT64`` runs that pass directly (the scan kernel
in s64).

The beyond-int32 tests are the lane's raison d'être: with a
``match=2**28`` constant-scoring matrix, a 20-residue self-hit scores
5.4e9 — unrepresentable in int32 — and both the direct BIT64 lane and
the EXACT ladder (f32 rung -> saturated range flag -> int64 terminal
rescore) must still produce the int64 oracle's number.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from libssa_tpu import matrices, oracle
from libssa_tpu.constants import BitWidth, SymType
from libssa_tpu.io.db import SequenceDB
from libssa_tpu.ops import interseq
from libssa_tpu.search.manager import SearchEngine, SearchParams, SearchStats

B62 = matrices.builtin("BLOSUM62")


def _db(n=20, seed=7, minlen=5, maxlen=60, alpha=20, extra=()):
    rng = np.random.default_rng(seed)
    seqs = [
        rng.integers(0, alpha, int(rng.integers(minlen, maxlen))).astype(np.uint8)
        for _ in range(n)
    ] + [np.asarray(e, np.uint8) for e in extra]
    st = SymType.AMINOACID if alpha == 20 else SymType.NUCLEOTIDE
    return SequenceDB.from_sequences(
        [f"s{i}" for i in range(len(seqs))], seqs, st
    ), seqs


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_bit64_search_matches_exact(local):
    """Hit lists (scores, ids, ordering) identical to the EXACT path."""
    db, _ = _db()
    rng = np.random.default_rng(8)
    q = rng.integers(0, 20, 33).astype(np.uint8)
    eng = SearchEngine(db, B62, 10, 1, SearchParams(batch_size=8))
    es, ei = eng.search(q, k=7, local=local, bit_width=BitWidth.EXACT)
    bs, bi = eng.search(q, k=7, local=local, bit_width=BitWidth.BIT64)
    np.testing.assert_array_equal(bs, es)
    np.testing.assert_array_equal(bi, ei)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_bit64_score_all_matches_oracle(local):
    db, seqs = _db(n=14, seed=9)
    rng = np.random.default_rng(10)
    q = rng.integers(0, 20, 24).astype(np.uint8)
    eng = SearchEngine(db, B62, 10, 1, SearchParams(batch_size=8))
    got = eng.score_all(q, local=local, bit_width=BitWidth.BIT64)
    fn = oracle.sw_score if local else oracle.nw_score
    np.testing.assert_array_equal(got, [fn(q, s, B62.scores, 10, 1) for s in seqs])


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_int64_lane_beyond_int32(local):
    """Scores int32 cannot hold: the lane's defining case.

    match=2**28 over a 20-residue self-hit -> 20 * 2**28 = 5.4e9. The
    direct BIT64 pass computes it natively; the EXACT ladder's f32 rung
    flags the range escape (saturating f32->s32 cast, probe-verified)
    and the int64 terminal rung rescores.
    """
    match = 2**28
    mat = matrices.constant_scoring(match, -4, SymType.NUCLEOTIDE)
    hot = np.tile(np.arange(4, dtype=np.uint8), 5)  # 20 residues
    db, seqs = _db(n=6, seed=11, alpha=4, extra=[hot])
    q = hot.copy()
    fn = oracle.sw_score if local else oracle.nw_score
    expect = np.asarray(
        [fn(q, s, mat.scores, 10, 2) for s in seqs], np.int64
    )
    assert expect.max() > 2**31, "test must exceed int32"

    eng = SearchEngine(db, mat, 10, 2, SearchParams(batch_size=8))
    got64 = eng.score_all(q, local=local, bit_width=BitWidth.BIT64)
    np.testing.assert_array_equal(got64, expect)

    stats = SearchStats()
    got_exact = eng.score_all(q, local=local, stats=stats)
    np.testing.assert_array_equal(got_exact, expect)
    # The f32 rung must have flagged the self-hit into the int64 rung.
    assert any(v > 0 for v in stats.rescored.values()), stats.rescored


@pytest.mark.parametrize("bw", [BitWidth.BIT8, BitWidth.BIT16])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_narrow_search_beyond_int32(bw, local):
    """The NARROW-width search path keeps beyond-int32 rescues exact.

    Review-caught regression: `_ladder_search_device`'s rescue used to
    scatter the int64 rescue scores through an int32 device top-k,
    wrapping them (5.4e9 -> 1.07e9) — the hit list ranked the true best
    hit below in-range subjects. The merge now happens on the host in
    int64; this pins the full ladder path BIT8/BIT16 -> escape ->
    rescue -> top-k against the oracle."""
    from libssa_tpu.ops.topk import host_topk

    match = 2**28
    mat = matrices.constant_scoring(match, -4, SymType.NUCLEOTIDE)
    hot = np.tile(np.arange(4, dtype=np.uint8), 5)  # 20 residues
    db, seqs = _db(n=6, seed=21, alpha=4, extra=[hot])
    q = hot.copy()
    fn = oracle.sw_score if local else oracle.nw_score
    want = np.asarray([fn(q, s, mat.scores, 10, 2) for s in seqs], np.int64)
    assert want.max() > 2**31
    w_s, w_i = host_topk(want, np.arange(len(seqs), dtype=np.int32), 4)

    eng = SearchEngine(db, mat, 10, 2, SearchParams(batch_size=8))
    stats = SearchStats()
    g_s, g_i = eng.search(q, 4, local=local, bit_width=bw, stats=stats)
    np.testing.assert_array_equal(g_s, w_s)
    np.testing.assert_array_equal(g_i, w_i)
    assert stats.rescored, "the hot self-hit must escape the window"


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_sharded_bit64_beyond_int32(dtype, local):
    """A mesh BIT64 request runs the DIRECT device-int64 sweep (r5,
    VERDICT r4 missing #3): the whole sharded sweep in s64 under a
    scoped x64 context, exact beyond int32 under any pinned dtype, with
    the int64 values surviving the device top-k merge and the fetch
    (the old path wrapped them through an int32 cast)."""
    from libssa_tpu.ops.topk import host_topk
    from libssa_tpu.parallel.sharded import (
        ShardedSearchEngine,
        make_db_mesh,
    )
    from libssa_tpu.search.manager import SearchStats

    match = 2**28
    mat = matrices.constant_scoring(match, -4, SymType.NUCLEOTIDE)
    hot = np.tile(np.arange(4, dtype=np.uint8), 5)
    db, seqs = _db(n=7, seed=22, alpha=4, extra=[hot])
    q = hot.copy()
    fn = oracle.sw_score if local else oracle.nw_score
    want = np.asarray([fn(q, s, mat.scores, 10, 2) for s in seqs], np.int64)
    assert want.max() > 2**31
    w_s, w_i = host_topk(want, np.arange(len(seqs), dtype=np.int32), 3)

    sh = ShardedSearchEngine(
        db, mat, 10, 2, make_db_mesh(4),
        SearchParams(batch_size=8, dtype=dtype),
    )
    st = SearchStats()
    g_s, g_i = sh.search(q, 3, local=local, bit_width=BitWidth.BIT64, stats=st)
    np.testing.assert_array_equal(g_s, w_s)
    np.testing.assert_array_equal(g_i, w_i)
    # Direct lane: no window flags exist, so no rung stats and exactly
    # one fetch (the int64 top lists) per sweep. requeued_chunks == 0
    # proves the SPMD s64 sweep itself ran (a throwing sweep would fall
    # back to the single-device lane and pass vacuously).
    assert sh.requeued_chunks == 0
    assert not st.rescored
    assert st.dispatches >= 1 and st.fetches >= 1


def test_sharded_bit64_requeue_stays_int64():
    """A faulted chunk re-queues on the single-device DIRECT s64 lane —
    beyond-int32 scores stay exact through the re-queue merge."""
    from libssa_tpu.ops.topk import host_topk
    from libssa_tpu.parallel.sharded import (
        ShardedSearchEngine,
        make_db_mesh,
    )

    match = 2**28
    mat = matrices.constant_scoring(match, -4, SymType.NUCLEOTIDE)
    hot = np.tile(np.arange(4, dtype=np.uint8), 5)
    db, seqs = _db(n=7, seed=23, alpha=4, extra=[hot])
    q = hot.copy()
    want = np.asarray(
        [oracle.sw_score(q, s, mat.scores, 10, 2) for s in seqs], np.int64
    )
    w_s, w_i = host_topk(want, np.arange(len(seqs), dtype=np.int32), 3)

    sh = ShardedSearchEngine(
        db, mat, 10, 2, make_db_mesh(4), SearchParams(batch_size=8)
    )

    def fail_first(step_idx):
        if step_idx == 0:
            raise RuntimeError("injected")

    sh.fault_injector = fail_first
    g_s, g_i = sh.search(q, 3, local=True, bit_width=BitWidth.BIT64)
    np.testing.assert_array_equal(g_s, w_s)
    np.testing.assert_array_equal(g_i, w_i)
    assert sh.requeued_chunks >= 1


def test_interseq_scores_int64_kernel_direct():
    """Kernel-level lock: dtype=int64 returns int64 and matches oracle."""
    rng = np.random.default_rng(12)
    q = rng.integers(0, 20, 17).astype(np.uint8)
    subs = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (9, 23, 14)]
    n_pad = max(len(s) for s in subs)
    from libssa_tpu.io.db import PAD_CODE
    from libssa_tpu.ops.scoring import make_profile

    chunk = np.full((len(subs), n_pad), PAD_CODE, np.int32)
    for i, s in enumerate(subs):
        chunk[i, : len(s)] = s
    lengths = np.asarray([len(s) for s in subs], np.int32)
    prof = make_profile(q, B62.padded())
    for local in (True, False):
        s, hi, lo = interseq.batch_scores_oracle_layout(
            prof, chunk, lengths, 11, 1, local, dtype=jnp.int64
        )
        assert s.dtype == np.int64
        fn = oracle.sw_score if local else oracle.nw_score
        np.testing.assert_array_equal(
            s, [fn(q, x, B62.scores, 10, 1) for x in subs]
        )
