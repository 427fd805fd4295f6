"""Hopper database-sweep kernel (ops/interseq_triton.py) in interpret mode.

Pallas interpret mode runs the kernel's logic on the CPU test mesh; the
compiled kernel is checked on the card by tests/test_gpu.py. Every case is
bit-exact against the scalar oracle or the XLA scan kernel, including the
wrapper's lane-block padding, strip padding, length bands, persistent
programs and multi-group tile tables, and the route rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libssa_tpu import matrices, oracle
from libssa_tpu.io.db import PAD_CODE
from libssa_tpu.ops import interseq, interseq_triton
from libssa_tpu.ops.scoring import make_padded_profile, make_profile
from libssa_tpu.search import kernels

B62 = matrices.builtin("BLOSUM62")
PADDED = B62.padded()


def _kernel(profile, codes, lengths, Q, R, **kw):
    s, hi, lo = interseq_triton.interseq_scores_triton(
        jnp.asarray(profile, jnp.int32),
        jnp.asarray(codes.T, jnp.int32),
        jnp.asarray(lengths, jnp.int32),
        Q,
        R,
        interpret=True,
        **kw,
    )
    return np.asarray(s), np.asarray(hi), np.asarray(lo)


def _random_batch(rng, B, minlen, maxlen):
    lengths = rng.integers(minlen, maxlen + 1, B).astype(np.int32)
    n_pad = int(lengths.max())
    codes = np.full((B, n_pad), PAD_CODE, dtype=np.int32)
    seqs = []
    for b in range(B):
        s = rng.integers(0, 20, lengths[b]).astype(np.uint8)
        seqs.append(s)
        codes[b, : lengths[b]] = s
    return codes, lengths, seqs


def _scan(profile, codes, lengths, Q, R, **kw):
    return interseq.batch_scores_oracle_layout(
        profile, codes, lengths, Q, R, track_range=True, **kw
    )


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("m", [1, 7, 33])
def test_kernel_bit_exact_vs_oracle(local, m):
    rng = np.random.default_rng(m)
    q = rng.integers(0, 20, m).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, seqs = _random_batch(rng, 9, 1, 40)
    s, _, _ = _kernel(profile, codes, lengths, 11, 1, local=local)
    fn = oracle.sw_score if local else oracle.nw_score
    expect = [fn(q, sq, B62.scores, 10, 1) for sq in seqs]
    np.testing.assert_array_equal(s, expect)


@pytest.mark.parametrize("gaps", [(3, 1), (0, 2), (5, 5)])
def test_kernel_gap_grid(gaps):
    go, ge = gaps
    rng = np.random.default_rng(go * 7 + ge)
    q = rng.integers(0, 20, 13).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, seqs = _random_batch(rng, 5, 1, 25)
    for local in (True, False):
        s, _, _ = _kernel(profile, codes, lengths, go + ge, ge, local=local)
        fn = oracle.sw_score if local else oracle.nw_score
        expect = [fn(q, sq, B62.scores, go, ge) for sq in seqs]
        np.testing.assert_array_equal(s, expect)


def test_kernel_zero_length_and_padding_lanes():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, 10).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes = np.full((3, 16), PAD_CODE, dtype=np.int32)
    lengths = np.array([0, 16, 4], dtype=np.int32)
    codes[1] = rng.integers(0, 20, 16)
    codes[2, :4] = rng.integers(0, 20, 4)
    s, _, _ = _kernel(profile, codes, lengths, 11, 1, local=True)
    assert s[0] == 0
    assert s[1] == oracle.sw_score(q, codes[1], B62.scores, 10, 1)
    assert s[2] == oracle.sw_score(q, codes[2, :4], B62.scores, 10, 1)
    # NW with zero-length subject = all-gap penalty
    s, _, _ = _kernel(profile, codes, lengths, 11, 1, local=False)
    assert s[0] == -(11 + 9 * 1)


def test_kernel_track_range_flags():
    rng = np.random.default_rng(4)
    q = rng.integers(0, 20, 120).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes = q[None, :].astype(np.int32)
    lengths = np.array([120], dtype=np.int32)
    s, hi, lo = _kernel(profile, codes, lengths, 11, 1, local=True,
                        track_range=True)
    expect = int(sum(B62.scores[c, c] for c in q))
    assert s[0] == expect and hi[0] == expect and lo[0] == 0 and expect > 255


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_kernel_matches_scan_kernel_large(local):
    """(scores, hi, lo) equal the scan's across a ragged batch whose 160
    lanes are not a multiple of the 128-lane tile (lane padding)."""
    rng = np.random.default_rng(5)
    q = rng.integers(0, 20, 50).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, _ = _random_batch(rng, 160, 0, 90)
    got = _kernel(profile, codes, lengths, 11, 1, local=local, track_range=True)
    want = _scan(profile, codes, lengths, 11, 1, local=local)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_kernel_m_not_multiple_of_strip(local):
    """The wrapper pads the profile to a whole number of strips (-64
    rows); results and NW captures are unchanged."""
    rng = np.random.default_rng(6)
    for m in (5, 32, 45):
        q = rng.integers(0, 20, m).astype(np.uint8)
        profile = make_profile(q, PADDED)
        codes, lengths, seqs = _random_batch(rng, 4, 1, 30)
        s, _, _ = _kernel(profile, codes, lengths, 11, 1, local=local,
                          track_range=True)
        fn = oracle.sw_score if local else oracle.nw_score
        expect = [fn(q, sq, B62.scores, 10, 1) for sq in seqs]
        np.testing.assert_array_equal(s, expect)


def test_kernel_odd_bucket_columns():
    """64/128-multiple bucket lengths (io/db._LADDER) run exactly: the
    column loop follows each tile's longest subject, whatever n_pad."""
    rng = np.random.default_rng(11)
    q = rng.integers(0, 20, 24).astype(np.uint8)
    profile = make_profile(q, PADDED)
    for n_pad in (320, 384):
        codes, lengths, seqs = _random_batch(rng, 4, n_pad - 70, n_pad)
        codes = np.pad(
            codes, ((0, 0), (0, n_pad - codes.shape[1])),
            constant_values=PAD_CODE,
        )
        for local in (True, False):
            s, _, _ = _kernel(profile, codes, lengths, 11, 1, local=local)
            fn = oracle.sw_score if local else oracle.nw_score
            expect = [fn(q, sq, B62.scores, 10, 1) for sq in seqs]
            np.testing.assert_array_equal(s, expect)


def test_kernel_long_query_matches_scan():
    """A query of many strips (300 rows) equals the scan kernel."""
    rng = np.random.default_rng(9)
    q = rng.integers(0, 20, 300).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, _ = _random_batch(rng, 8, 20, 60)
    for local in (True, False):
        got = _kernel(profile, codes, lengths, 11, 1, local=local,
                      track_range=True)
        want = _scan(profile, codes, lengths, 11, 1, local=local)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lanes", [8, 64])
def test_lane_block_padding(lanes):
    """Batches that are not a multiple of the tile's lanes pad with PAD
    lanes of length 0, which never leak into real results."""
    rng = np.random.default_rng(lanes)
    q = rng.integers(0, 20, 20).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, seqs = _random_batch(rng, 70, 0, 30)
    [(s, hi, lo)] = interseq_triton.sweep_scores(
        jnp.asarray(profile, jnp.int32)[None],
        [(jnp.asarray(codes.T, jnp.int8)[None], jnp.asarray(lengths)[None],
          jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))],
        jnp.asarray([20], jnp.int32), 11, 1, local=True, interpret=True,
        lanes=lanes,
    )
    assert s.shape == (1, 70)
    expect = [oracle.sw_score(q, sq, B62.scores, 10, 1) for sq in seqs]
    np.testing.assert_array_equal(np.asarray(s)[0], expect)


@pytest.mark.parametrize("m_real", [33, 50])
def test_traced_nw_m_real(m_real):
    """NW captures at a TRACED m_real: one jitted sweep over a 64-row
    padded profile serves both query lengths."""
    rng = np.random.default_rng(m_real)
    q = rng.integers(0, 20, m_real).astype(np.uint8)
    profile = make_padded_profile(q, PADDED, rows=64)
    codes, lengths, seqs = _random_batch(rng, 6, 0, 40)
    fn = jax.jit(
        lambda mr: interseq_triton.interseq_scores_triton(
            jnp.asarray(profile), jnp.asarray(codes.T), jnp.asarray(lengths),
            11, 1, local=False, track_range=True, m_real=mr, interpret=True,
        )
    )
    s, hi, lo = (np.asarray(x) for x in fn(jnp.int32(m_real)))
    expect = [oracle.nw_score(q, sq, B62.scores, 10, 1) for sq in seqs]
    np.testing.assert_array_equal(s, expect)
    want = _scan(profile, codes, lengths, 11, 1, local=False, m_real=m_real)
    np.testing.assert_array_equal(hi, want[1])
    np.testing.assert_array_equal(lo, want[2])


def _groups(rng):
    """Three chunk-shape groups of a multi-query sweep."""
    groups = []
    for g, n_pad, B in ((2, 16, 8), (1, 40, 16), (3, 24, 8)):
        codes = rng.integers(0, 20, (g, n_pad, B)).astype(np.int8)
        lens = rng.integers(0, n_pad + 1, (g, B)).astype(np.int32)
        codes[np.arange(n_pad)[None, :, None] >= lens[:, None, :]] = PAD_CODE
        groups.append((jnp.asarray(codes), jnp.asarray(lens)))
    return groups


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_grouped_chunks_multi_query(local):
    """All groups of a stage in one call, every (query, chunk) pair, equal
    the scan route pair for pair."""
    rng = np.random.default_rng(21 + local)
    queries = [rng.integers(0, 20, m).astype(np.uint8) for m in (20, 31)]
    profiles = jnp.asarray(
        np.stack([make_padded_profile(q, PADDED, rows=32) for q in queries]),
        jnp.int32,
    )
    m_reals = jnp.asarray([20, 31], jnp.int32)
    stacks = []
    for codes, lens in _groups(rng):
        g = codes.shape[0]
        iq = jnp.repeat(jnp.arange(2, dtype=jnp.int32), g)
        ic = jnp.tile(jnp.arange(g, dtype=jnp.int32), 2)
        stacks.append((codes, lens, iq, ic))
    kw = dict(local=local, use_matmul=False, track_range=True,
              dtype=jnp.int32)
    got = kernels.sweep_groups("interpret", profiles, stacks, m_reals, 11, 1, **kw)
    want = kernels.sweep_groups("scan", profiles, stacks, m_reals, 11, 1, **kw)
    for g_out, w_out in zip(got, want):
        for a, b in zip(g_out, w_out):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_length_bands_and_persistent_programs(monkeypatch):
    """Groups split into several length-band launches, and a grid far
    smaller than the tile count (each program loops over tiles), change
    nothing."""
    rng = np.random.default_rng(31)
    q = rng.integers(0, 20, 25).astype(np.uint8)
    prof = jnp.asarray(make_padded_profile(q, PADDED), jnp.int32)
    stacks = [(c, l, jnp.zeros((c.shape[0],), jnp.int32),
               jnp.arange(c.shape[0], dtype=jnp.int32))
              for c, l in _groups(rng)]
    m_reals = jnp.asarray([25], jnp.int32)
    want = kernels.sweep_groups(
        "scan", prof[None], stacks, m_reals, 11, 1, local=True,
        use_matmul=False, track_range=True, dtype=jnp.int32,
    )
    monkeypatch.setattr(interseq_triton, "BANDS", (16, 24))
    got = interseq_triton.sweep_scores(
        prof[None], stacks, m_reals, 11, 1, local=True, track_range=True,
        interpret=True, max_programs=3,
    )
    for g_out, w_out in zip(got, want):
        for a, b in zip(g_out, w_out):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_route_rule():
    """One rule: the kernel on a GPU backend, the scan otherwise; int64
    and any score bound the int32 kernel cannot hold force the scan."""
    assert kernels.route() == "scan"  # the CPU test backend
    assert kernels.route("auto") == "scan"
    assert kernels.route("pallas") == "pallas"
    assert kernels.route("interpret", "int32") == "interpret"
    assert kernels.route("pallas", "int64") == "scan"
    assert kernels.route("pallas", "float32", kernels.KERNEL_SCORE_LIMIT) == "scan"
    assert kernels.route("pallas", "float32", kernels.KERNEL_SCORE_LIMIT - 1) == "pallas"
    with pytest.raises(ValueError, match="unknown kernel"):
        kernels.route("mosaic")


def test_stage_sweep_normalizes_route_args():
    """Equivalent requests share one closure set: the kernel ignores the
    gather flag and int64 forces the scan's take-gather."""
    a = kernels.stage_sweep("interpret", 11, 1, True, True, "int32", None)
    b = kernels.stage_sweep("interpret", 11, 1, True, False, "int32", None)
    assert a is b
    c = kernels.stage_sweep("pallas", 11, 1, True, True, "int64", None)
    d = kernels.stage_sweep("scan", 11, 1, True, False, "int64", None)
    assert c is d


def test_manager_route_follows_score_bound():
    """The engine keeps large-score matrices off the int32 kernel even
    when the kernel is forced."""
    from libssa_tpu.constants import SymType
    from libssa_tpu.io.db import SequenceDB
    from libssa_tpu.search.manager import SearchEngine, SearchParams

    seqs = [np.arange(4, dtype=np.uint8)] * 3
    db = SequenceDB.from_sequences(["a", "b", "c"], seqs, SymType.NUCLEOTIDE)
    big = matrices.constant_scoring(2**28, -4, SymType.NUCLEOTIDE)
    small = matrices.constant_scoring(5, -4, SymType.NUCLEOTIDE)
    forced = SearchParams(kernel="pallas")
    assert SearchEngine(db, big, 10, 2, forced)._route(32, "float32") == "scan"
    assert SearchEngine(db, small, 10, 2, forced)._route(32, "float32") == "pallas"
