"""Inter-sequence kernel vs scalar oracle: bit-exactness lock.

Replicates the reference's oracle pattern (SURVEY.md §4): the vectorized
kernel must produce bit-identical scores to the 64-bit scalar path on
random batches, across SW/NW, gap parameter grids, ragged lengths, and both
profile-gather strategies. Also locks the ladder overflow flags.
"""
import numpy as np
import pytest

from libssa_tpu import matrices, oracle
from libssa_tpu.io.db import PAD_CODE
from libssa_tpu.ops import interseq
from libssa_tpu.ops.scoring import make_profile

B62 = matrices.builtin("BLOSUM62")
PADDED = B62.padded()


def _random_batch(rng, B, minlen, maxlen, alpha=20):
    lengths = rng.integers(minlen, maxlen + 1, B).astype(np.int32)
    n_pad = int(lengths.max())
    codes = np.full((B, n_pad), PAD_CODE, dtype=np.int32)
    seqs = []
    for b in range(B):
        s = rng.integers(0, alpha, lengths[b]).astype(np.uint8)
        seqs.append(s)
        codes[b, : lengths[b]] = s
    return codes, lengths, seqs


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("use_matmul", [True, False], ids=["mxu", "gather"])
def test_bit_exact_vs_oracle(local, use_matmul):
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, 33).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, seqs = _random_batch(rng, 17, 1, 60)
    gap_open, gap_extend = 10, 1
    Q, R = gap_open + gap_extend, gap_extend
    scores, _, _ = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, Q, R, local=local, use_matmul=use_matmul
    )
    fn = oracle.sw_score if local else oracle.nw_score
    expect = [fn(q, s, B62.scores, gap_open, gap_extend) for s in seqs]
    np.testing.assert_array_equal(scores, expect)


@pytest.mark.parametrize("gaps", [(3, 1), (0, 2), (12, 4), (5, 5), (40, 1)])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_gap_parameter_grid(gaps, local):
    gap_open, gap_extend = gaps
    rng = np.random.default_rng(gap_open * 31 + gap_extend)
    q = rng.integers(0, 20, 11).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, seqs = _random_batch(rng, 9, 1, 25)
    Q, R = gap_open + gap_extend, gap_extend
    scores, _, _ = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, Q, R, local=local
    )
    fn = oracle.sw_score if local else oracle.nw_score
    expect = [fn(q, s, B62.scores, gap_open, gap_extend) for s in seqs]
    np.testing.assert_array_equal(scores, expect)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_ragged_and_padded_lanes(local):
    """Lanes padded far beyond their length and zero-length lanes."""
    rng = np.random.default_rng(5)
    q = rng.integers(0, 20, 8).astype(np.uint8)
    profile = make_profile(q, PADDED)
    B, n_pad = 6, 64
    codes = np.full((B, n_pad), PAD_CODE, dtype=np.int32)
    lengths = np.array([1, 3, 0, 64, 17, 0], dtype=np.int32)
    seqs = []
    for b in range(B):
        s = rng.integers(0, 20, lengths[b]).astype(np.uint8)
        seqs.append(s)
        codes[b, : lengths[b]] = s
    Q, R = 11, 1
    scores, _, _ = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, Q, R, local=local
    )
    fn = oracle.sw_score if local else oracle.nw_score
    expect = [fn(q, s, B62.scores, 10, 1) for s in seqs]
    np.testing.assert_array_equal(scores, expect)


def test_long_identical_pair():
    """High-score regime: long identical sequences (ladder territory)."""
    rng = np.random.default_rng(9)
    q = rng.integers(0, 20, 150).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes = q[None, :].astype(np.int32)
    lengths = np.array([150], dtype=np.int32)
    scores, hi, lo = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, 11, 1, local=True, track_range=True
    )
    expect = int(sum(B62.scores[c, c] for c in q))
    assert scores[0] == expect
    assert hi[0] == expect  # running max equals final best for SW self-hit


def test_overflow_flags_sw():
    rng = np.random.default_rng(9)
    q = rng.integers(0, 20, 150).astype(np.uint8)
    profile = make_profile(q, PADDED)
    # Lane 0: identical to query (score ~> 600, overflows 8-bit window).
    # Lane 1: short unrelated (score < 255, no overflow).
    short = rng.integers(0, 20, 10).astype(np.uint8)
    n_pad = 150
    codes = np.full((2, n_pad), PAD_CODE, dtype=np.int32)
    codes[0] = q
    codes[1, :10] = short
    lengths = np.array([150, 10], dtype=np.int32)
    scores, hi, lo = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, 11, 1, local=True, track_range=True
    )
    flags8 = interseq.overflow_flags(scores, hi, lo, 255, local=True)
    flags16 = interseq.overflow_flags(scores, hi, lo, 32767, local=True)
    assert bool(flags8[0]) is True
    assert bool(flags8[1]) is False
    assert not flags16.any()
    assert interseq.overflow_flags(scores, hi, lo, None, local=True).sum() == 0


def test_overflow_flags_nw_underflow():
    """NW can leave the window from below (long gap run)."""
    rng = np.random.default_rng(10)
    q = rng.integers(0, 20, 20).astype(np.uint8)
    profile = make_profile(q, PADDED)
    # Very long subject vs short query: global score is a huge negative.
    s = rng.integers(0, 20, 400).astype(np.uint8)
    codes = s[None, :].astype(np.int32)
    lengths = np.array([400], dtype=np.int32)
    scores, hi, lo = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, 11, 1, local=False, track_range=True
    )
    expect = oracle.nw_score(q, s, B62.scores, 10, 1)
    assert scores[0] == expect
    flags = interseq.overflow_flags(scores, hi, lo, 255, local=False)
    assert bool(flags[0]) is True


def test_batch_consistency_with_singletons():
    """Scoring a batch must equal scoring each lane alone."""
    rng = np.random.default_rng(11)
    q = rng.integers(0, 20, 19).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, seqs = _random_batch(rng, 13, 2, 40)
    batch_scores, _, _ = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, 11, 1, local=True
    )
    for b in range(13):
        solo, _, _ = interseq.batch_scores_oracle_layout(
            profile, codes[b : b + 1], lengths[b : b + 1], 11, 1, local=True
        )
        assert solo[0] == batch_scores[b]


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_float32_dtype_bit_exact(local):
    """f32 DP is exact for integer scores within the 2**24 window."""
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    q = rng.integers(0, 20, 40).astype(np.uint8)
    profile = make_profile(q, PADDED)
    codes, lengths, seqs = _random_batch(rng, 11, 1, 70)
    i32, _, _ = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, 11, 1, local=local, dtype=jnp.int32
    )
    f32, _, _ = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, 11, 1, local=local, dtype=jnp.float32
    )
    np.testing.assert_array_equal(i32, f32)
    assert f32.dtype == np.int32


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_m_real_padded_profile(local):
    """Profile padded with -64 rows + m_real == unpadded results."""
    rng = np.random.default_rng(33)
    q = rng.integers(0, 20, 21).astype(np.uint8)
    profile = make_profile(q, PADDED)
    padded_prof = np.pad(profile, ((0, 11), (0, 0)), constant_values=-64)
    codes, lengths, seqs = _random_batch(rng, 7, 1, 50)
    base = interseq.batch_scores_oracle_layout(
        profile, codes, lengths, 11, 1, local=local, track_range=True
    )
    padded = interseq.batch_scores_oracle_layout(
        padded_prof, codes, lengths, 11, 1, local=local, track_range=True,
        m_real=21,
    )
    for a, b in zip(base, padded):
        np.testing.assert_array_equal(a, b)


def test_pair_scores_batch_large_matrix_exact():
    """pair_scores_batch must not wrap large-entry matrices in the int8
    one-hot dot gather (review finding: the scan path passed use_matmul=True
    unguarded, bypassing the engine's |score|<=127 gate)."""
    from libssa_tpu import matrices as M
    from libssa_tpu.constants import SymType
    from libssa_tpu.ops.interseq import pair_scores_batch

    mat = M.constant_scoring(200, -200, SymType.NUCLEOTIDE)
    rng = np.random.default_rng(7)
    q = rng.integers(0, 4, 12).astype(np.uint8)
    subs = np.stack([q, rng.integers(0, 4, 12).astype(np.uint8)])
    prof = make_profile(q, mat.padded())
    got = np.asarray(
        pair_scores_batch(
            prof, subs, np.full(2, 12, np.int32), 11, 1, local=True,
            kernel="scan",
        )
    )
    want = [oracle.sw_score(q, s, mat.scores, 10, 1) for s in subs]
    np.testing.assert_array_equal(got, want)
