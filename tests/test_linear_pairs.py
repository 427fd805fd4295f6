"""Linear-space tracebacks (search/hirschberg.align_pair_linear) on the
pair shapes long tracebacks produce.

Every case checks the score against the int64 oracle AND re-scores the
returned CIGAR path independently, for SW and NW under both gap
conventions; ``LEAF_CELLS`` is moved so pairs sit just below, just above
and far above the leaf threshold (direct fill vs one or many divide
levels).
"""
import numpy as np
import pytest

from libssa_tpu import matrices, oracle
from libssa_tpu.constants import SymType
from libssa_tpu.search import hirschberg as hb

B62 = matrices.builtin("BLOSUM62")


def _pair(m, n, seed, hi=20):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, hi, m).astype(np.uint8),
        rng.integers(0, hi, n).astype(np.uint8),
    )


def _path_score(q, s, tb, sub, Q, R):
    """Independent evaluation of a traceback path's score."""
    i, j = tb.q_begin, tb.s_begin
    total, run = 0, None
    for op in tb.cigar:
        if op == "M":
            total += int(sub[q[i], s[j]])
            i, j, run = i + 1, j + 1, None
        else:
            total -= R if run == op else Q
            run = op
            if op == "D":
                i += 1
            else:
                j += 1
    assert (i, j) == (tb.q_end, tb.s_end)
    return total


def _check(q, s, local, go=10, ge=1, fro=True, matrix=B62):
    Q, R = oracle.gap_qr(go, ge, fro)
    tb = hb.align_pair_linear(q, s, matrix.scores, go, ge, local, fro)
    want = (oracle.sw_score if local else oracle.nw_score)(
        q, s, matrix.scores, go, ge, fro
    )
    assert tb.score == want
    if tb.cigar:
        assert _path_score(q, s, tb, matrix.scores, Q, R) == want
    else:
        assert local and want == 0
    return tb


@pytest.mark.parametrize("m,n", [(40, 60), (300, 200), (513, 287), (96, 700)])
@pytest.mark.parametrize("fro", [True, False], ids=["q=open+ext", "q=open"])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_divide_levels_grid(monkeypatch, m, n, fro, local):
    """Several divide levels (tiny leaves) on every aspect ratio."""
    monkeypatch.setattr(hb, "LEAF_CELLS", 2048)
    q, s = _pair(m, n, m * 7 + n)
    _check(q, s, local, 10, 1, fro)


@pytest.mark.parametrize("m,n", [(500, 400), (260, 600)])
@pytest.mark.parametrize("side", ["below", "above"])
def test_pairs_straddling_leaf_cells(monkeypatch, m, n, side):
    """A pair one cell inside the leaf bound solves directly; one cell
    over it divides once — both exact, SW and NW."""
    monkeypatch.setattr(hb, "LEAF_CELLS", m * n if side == "below" else m * n - 1)
    q, s = _pair(m, n, m + n)
    for local in (True, False):
        _check(q, s, local)


@pytest.mark.parametrize("m,n", [(50, 80), (300, 300), (430, 190)])
def test_sw_end_and_start_cells(monkeypatch, m, n):
    """SW coordinates equal the oracle traceback's (smallest end cell on
    ties, then the reverse pass's start)."""
    monkeypatch.setattr(hb, "LEAF_CELLS", 4096)
    q, s = _pair(m, n, m * 11 + n)
    tb = _check(q, s, True)
    want = oracle.sw_align(q, s, B62.scores, 10, 1)
    assert (tb.q_end, tb.s_end) == (want.q_end, want.s_end)


def test_sw_end_cell_tie_break():
    """A repeated motif: many cells share the best score; the end cell is
    the smallest (i, j), as the matrix aligner's argmax picks."""
    motif = np.array([12, 4, 9, 1, 17, 3], dtype=np.intp)
    q, s = np.tile(motif, 50), np.tile(motif, 60)
    Q, R = oracle.gap_qr(10, 1)
    score, ei, ej = hb._score_end_sw(q, s, B62.scores, Q, R)
    H, _, _ = oracle._dp_matrices(q, s, B62.scores, Q, R, local=True)
    i, j = np.unravel_index(int(H.argmax()), H.shape)
    assert (score, ei, ej) == (int(H.max()), int(i), int(j))


@pytest.mark.parametrize("shape", [(400, 30), (30, 400), (250, 250)])
def test_gap_heavy_shapes_both_conventions(monkeypatch, shape):
    """Gap-heavy NW shapes (m >> n, n >> m) hit every (tb, te) boundary
    contract of the divide; both gap conventions."""
    monkeypatch.setattr(hb, "LEAF_CELLS", 1024)
    q, s = _pair(*shape, shape[0] + 3 * shape[1])
    for fro in (True, False):
        _check(q, s, False, 6, 2, fro)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("m,n,seed", [(200, 333, 1), (97, 510, 2)])
def test_long_pair_grid(monkeypatch, local, m, n, seed):
    monkeypatch.setattr(hb, "LEAF_CELLS", 4096)
    q, s = _pair(m, n, seed)
    _check(q, s, local, 11, 1)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_leaf_threshold_does_not_change_alignment(monkeypatch, local):
    """Deep recursion and a direct leaf solve give the same score and a
    path of that score."""
    q, s = _pair(200, 333, 1)
    monkeypatch.setattr(hb, "LEAF_CELLS", 512)
    deep = _check(q, s, local, 11, 1)
    monkeypatch.setattr(hb, "LEAF_CELLS", 10**9)
    direct = _check(q, s, local, 11, 1)
    assert deep.score == direct.score


def test_gap_convention_long_pair(monkeypatch):
    monkeypatch.setattr(hb, "LEAF_CELLS", 4096)
    q, s = _pair(120, 300, 3)
    for fro in (True, False):
        _check(q, s, True, 6, 2, fro)


def test_nucleotide_pair(monkeypatch):
    monkeypatch.setattr(hb, "LEAF_CELLS", 2048)
    mat = matrices.constant_scoring(5, -4, SymType.NUCLEOTIDE)
    q, s = _pair(100, 257, 4, hi=4)
    _check(q, s, True, 10, 2, matrix=mat)


def test_large_entry_matrix(monkeypatch):
    """Entries far beyond int8/bf16 range stay exact in int64."""
    monkeypatch.setattr(hb, "LEAF_CELLS", 1024)
    mat = matrices.constant_scoring(500, -400, SymType.NUCLEOTIDE)
    q, s = _pair(64, 128, 6, hi=4)
    for local in (True, False):
        _check(q, s, local, 300, 100, matrix=mat)


def test_small_pair_direct_leaf():
    """Pairs below LEAF_CELLS solve in one leaf, exactly."""
    q, s = _pair(20, 30, 8)
    for local in (True, False):
        _check(q, s, local, 11, 1)
