"""Long-pair row-sweep scorer (ops/longpair.py).

The single-enormous-pair path (``align_pair`` SCORE mode) must be
bit-exact vs the int64 oracle for SW and NW under both gap conventions,
across alphabets, pair shapes and the f32/int32 arithmetic split. The
card runs the same scan in tests/test_gpu.py.
"""
import numpy as np
import pytest

from libssa_tpu import matrices, oracle
from libssa_tpu.ops.longpair import (
    longpair_score,
    score_bound,
    subject_profile,
)

B62 = matrices.builtin("BLOSUM62")


@pytest.mark.parametrize("go,ge", [(10, 1), (5, 2), (20, 1)])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_scan_matches_oracle(go, ge, local):
    rng = np.random.default_rng(go * 100 + ge + local)
    for m, n in [(3, 5), (60, 40), (257, 513), (100, 1025)]:
        q = rng.integers(0, 20, m).astype(np.uint8)
        s = rng.integers(0, 20, n).astype(np.uint8)
        want = (oracle.sw_score if local else oracle.nw_score)(
            q, s, B62.scores, go, ge
        )
        got = longpair_score(q, s, B62.padded(), go, ge, local=local)
        assert got == want, (m, n)


def test_gap_convention_knob():
    rng = np.random.default_rng(7)
    q = rng.integers(0, 20, 50).astype(np.uint8)
    s = rng.integers(0, 20, 70).astype(np.uint8)
    for fro in (True, False):
        want = oracle.sw_score(q, s, B62.scores, 10, 1, fro)
        got = longpair_score(
            q, s, B62.padded(), 10, 1, local=True,
            first_residue_opens=fro,
        )
        assert got == want


def test_empty_inputs():
    q = np.zeros(0, np.uint8)
    s = np.arange(5, dtype=np.uint8) % 4
    assert longpair_score(q, s, B62.padded(), 10, 1, True) == 0
    nw = longpair_score(q, s, B62.padded(), 10, 1, False)
    assert nw == -(11 + 4 * 1)  # Q + (n-1) R


def test_int32_escape_path():
    """Scores past the f32 window run the int32 scan — still exact."""
    import jax.numpy as jnp

    from libssa_tpu.ops.longpair import longpair_score_scan

    rng = np.random.default_rng(9)
    q = rng.integers(0, 20, 80).astype(np.uint8)
    s = rng.integers(0, 20, 100).astype(np.uint8)
    P = subject_profile(s, B62.padded())
    P = np.pad(P, ((0, 0), (0, 412)), constant_values=-64)
    qi = np.pad(q.astype(np.int32), (0, 176), constant_values=31)
    got = int(
        longpair_score_scan(
            jnp.asarray(P, jnp.int32), jnp.asarray(qi), 11, 1, 80, 100,
            local=True, dtype_name="int32",
        )
    )
    assert got == oracle.sw_score(q, s, B62.scores, 10, 1)


def test_score_bound_monotone():
    b = score_bound(100, 200, B62.scores, 11, 1)
    assert b >= 100 * 11  # min-side * max |sub|
    assert score_bound(10**6, 10**6, B62.scores, 11, 1) >= 2**23


def test_score_bound_ignores_pad_fill():
    """The -64 pad fill must not inflate the bound (it routed genome-scale
    pairs off the kernel-rate f32 path: 300k pairs bounded 19.5M > 2**24
    with the padded max instead of the true ~3.6M)."""
    raw = score_bound(300_000, 300_000, B62.scores, 12, 1)
    padded = score_bound(300_000, 300_000, B62.padded(), 12, 1)
    assert raw < 2**24
    assert padded < 2**24  # stays on the f32 kernel path
    # padded adds only the bounded pad-run slack, not 64-per-residue
    assert raw <= padded <= raw + 64 * 1024
    # uniform constant matrix (no pad rows): stripping must not misfire
    cm = matrices.constant_scoring(1, -1, B62.symtype)
    assert score_bound(100, 100, cm.scores, 5, 1) == 100 * 1 + 5 + 100 * 1


def _pair_check(q, s, local, go=10, ge=1, matrix=B62):
    want = (oracle.sw_score if local else oracle.nw_score)(
        q, s, matrix.scores, go, ge
    )
    assert longpair_score(q, s, matrix.padded(), go, ge, local=local) == want


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_cross_span_pairs(local):
    """Pairs far wider than one 512-column pad block and of every
    height/width ratio, across gap penalties."""
    rng = np.random.default_rng(31 + local)
    for m, n, go, ge in [(40, 60, 10, 1), (9, 300, 5, 2), (130, 1100, 20, 1)]:
        q = rng.integers(0, 20, m).astype(np.uint8)
        s = rng.integers(0, 20, n).astype(np.uint8)
        _pair_check(q, s, local, go, ge)


def test_multiblock_query():
    """A query spanning several 256-row pad blocks."""
    rng = np.random.default_rng(77)
    q = rng.integers(0, 20, 600).astype(np.uint8)
    s = rng.integers(0, 20, 500).astype(np.uint8)
    _pair_check(q, s, True)


@pytest.mark.parametrize("m,n", [(40, 60), (300, 700)])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_taller_pairs_exact(m, n, local):
    """Short and tall pairs, including the NW capture at the last row
    and column."""
    rng = np.random.default_rng(m + n + local)
    q = rng.integers(0, 20, m).astype(np.uint8)
    s = rng.integers(0, 20, n).astype(np.uint8)
    _pair_check(q, s, local)


@pytest.mark.parametrize("hi", [4, 15, 20, 24])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_alphabet_sizes_exact(hi, local):
    """Nucleotide (4, 15) and protein (20, 24) code ranges, with the top
    code present, are exact; PAD columns and rows only decay."""
    rng = np.random.default_rng(hi * 10 + local)
    for m, n in [(50, 70), (200, 450)]:
        q = rng.integers(0, hi, m).astype(np.uint8)
        s = rng.integers(0, hi, n).astype(np.uint8)
        q[0] = s[0] = hi - 1
        _pair_check(q, s, local)


@pytest.mark.parametrize("m,n", [(45, 65), (260, 520), (130, 1100)])
@pytest.mark.parametrize("gaps", [(10, 1), (5, 2)])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_size_gap_grid_exact(m, n, gaps, local):
    rng = np.random.default_rng(m * 3 + n + local + gaps[0])
    q = rng.integers(0, 20, m).astype(np.uint8)
    s = rng.integers(0, 20, n).astype(np.uint8)
    _pair_check(q, s, local, *gaps)


def test_large_entry_matrix_exact():
    """Substitution entries far beyond int8 (200) stay exact."""
    scores = np.full((32, 32), -64, np.int64)
    A = 25
    scores[:A, :A] = -3
    np.fill_diagonal(scores[:A, :A], 200)
    rng = np.random.default_rng(4)
    q = rng.integers(0, 25, 40).astype(np.uint8)
    s = rng.integers(0, 25, 55).astype(np.uint8)
    want = oracle.sw_score(q, s, scores[:A, :A], 11, 1)
    assert longpair_score(q, s, scores, 11, 1, local=True) == want


def test_subject_profile_layout():
    """P[a, j] = sub(a, s[j]): one row per alphabet symbol."""
    rng = np.random.default_rng(2)
    s = rng.integers(0, 20, 33).astype(np.uint8)
    P = subject_profile(s, B62.padded())
    assert P.shape == (32, 33)
    np.testing.assert_array_equal(P[:, 5], B62.padded()[:, s[5]])


def test_real_max_abs_strips_pad_fill():
    from libssa_tpu.ops.longpair import real_max_abs

    assert real_max_abs(B62.scores) == (int(np.abs(B62.scores).max()), False)
    mx, padded = real_max_abs(B62.padded())
    assert padded and mx == int(np.abs(B62.scores).max())
    cm = matrices.constant_scoring(7, -2, B62.symtype)
    assert real_max_abs(cm.scores) == (7, False)


def test_f32_window_routes_int32_scan():
    """A pair whose bound leaves the f32 window runs the int32 scan and
    stays exact."""
    from libssa_tpu.constants import SymType

    big = matrices.constant_scoring(2**20, -3, SymType.NUCLEOTIDE)
    rng = np.random.default_rng(12)
    q = rng.integers(0, 4, 60).astype(np.uint8)
    s = np.concatenate([q[5:55], rng.integers(0, 4, 30).astype(np.uint8)])
    assert score_bound(60, 80, big.padded(), 12, 2) >= 2**24
    for local in (True, False):
        _pair_check(q, s, local, 10, 2, big)
