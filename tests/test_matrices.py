"""Substitution-matrix data and parser tests (reference: matrices.c suite)."""
import numpy as np
import pytest

from libssa_tpu import matrices
from libssa_tpu.constants import AA_ALPHABET, PADDED_ALPHABET, SymType


@pytest.mark.parametrize("name", matrices.BUILTIN_NAMES)
def test_builtin_symmetric(name):
    m = matrices.builtin(name)
    np.testing.assert_array_equal(m.scores, m.scores.T)


@pytest.mark.parametrize("name", matrices.BUILTIN_NAMES)
def test_builtin_diagonal_positive(name):
    # Every residue must score itself positively (X may be <= 0).
    m = matrices.builtin(name)
    diag = np.diag(m.scores)
    real = [AA_ALPHABET.index(c) for c in "ARNDCQEGHILKMFPSTWYV"]
    assert (diag[real] > 0).all()


def test_blosum62_spot_values():
    m = matrices.builtin("BLOSUM62")
    a = AA_ALPHABET.index
    assert m.score(a("W"), a("W")) == 11
    assert m.score(a("C"), a("C")) == 9
    assert m.score(a("A"), a("A")) == 4
    assert m.score(a("A"), a("R")) == -1
    assert m.score(a("E"), a("Z")) == 4
    assert m.score(a("N"), a("B")) == 3
    assert m.score(a("*"), a("*")) == 1
    assert m.score(a("W"), a("*")) == -4


def test_spot_values_other_matrices():
    a = AA_ALPHABET.index
    assert matrices.builtin("BLOSUM45").score(a("W"), a("W")) == 15
    assert matrices.builtin("BLOSUM50").score(a("C"), a("C")) == 13
    assert matrices.builtin("BLOSUM80").score(a("W"), a("W")) == 11
    assert matrices.builtin("BLOSUM90").score(a("C"), a("C")) == 9
    assert matrices.builtin("PAM250").score(a("W"), a("W")) == 17
    assert matrices.builtin("PAM30").score(a("M"), a("M")) == 11
    assert matrices.builtin("PAM70").score(a("W"), a("W")) == 13


def test_padded_table():
    m = matrices.builtin("BLOSUM62")
    p = m.padded()
    assert p.shape == (PADDED_ALPHABET, PADDED_ALPHABET)
    assert p.dtype == np.int32
    np.testing.assert_array_equal(p[: m.alphabet_size, : m.alphabet_size], m.scores)
    assert (p[m.alphabet_size :, :] == -64).all()
    assert (p[:, m.alphabet_size :] == -64).all()
    assert -128 <= p.min() and p.max() <= 127  # int8-representable for the one-hot dot


def test_unknown_builtin_raises():
    with pytest.raises(ValueError):
        matrices.builtin("BLOSUM999")


def test_from_file_roundtrip(tmp_path):
    # Write BLOSUM62 out in NCBI format and parse it back.
    m = matrices.builtin("BLOSUM62")
    path = tmp_path / "mat.txt"
    lines = ["# test matrix", "   " + "  ".join(AA_ALPHABET)]
    for i, c in enumerate(AA_ALPHABET):
        lines.append(c + " " + " ".join(str(v) for v in m.scores[i]))
    path.write_text("\n".join(lines))
    m2 = matrices.from_file(str(path))
    np.testing.assert_array_equal(m.scores, m2.scores)


def test_from_file_rejects_garbage(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("A B C\n1 2 3\n")
    with pytest.raises(ValueError):
        matrices.from_file(str(path))


def test_constant_scoring():
    m = matrices.constant_scoring(5, -4)
    assert m.symtype is SymType.NUCLEOTIDE
    assert m.score(0, 0) == 5
    assert m.score(0, 1) == -4
    np.testing.assert_array_equal(m.scores, m.scores.T)
    with pytest.raises(ValueError):
        matrices.constant_scoring(1, 2)
