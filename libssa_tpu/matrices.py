"""Substitution matrices: built-in BLOSUM/PAM, matrix-from-file, constant.

Counterpart of the reference's ``src/matrices.c`` (SURVEY.md §2
"Substitution matrices"): built-in BLOSUM45/50/62/80/90 and PAM30/70/250,
NCBI-format matrix file parsing, and constant match/mismatch scoring. The
reference widens each matrix into 8/16/64-bit tables for its kernel
precisions; here every kernel computes in 32 bits (or the int64 lane), so
we keep one canonical int32 table plus an int8 copy for the scan's one-hot
dot gather (int8 x int8 -> int32).

Provenance note: the reference checkout was empty at survey time
(SURVEY.md §0), so the table text below is reproduced from the standard NCBI
data files rather than copied from the reference. The values are the
published NCBI tables; ``tests/test_matrices.py`` locks symmetry and
well-known spot values. Any cell that disagrees with NCBI data is a data bug
to fix, not an algorithm change — the engine is value-agnostic.
"""
from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from .constants import AA_ALPHABET, NT_ALPHABET, PADDED_ALPHABET, SymType

# ---------------------------------------------------------------------------
# NCBI-format matrix text (rows/cols in ARNDCQEGHILKMFPSTWYVBZX* order)
# ---------------------------------------------------------------------------

_BLOSUM62 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
R -1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
N -2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
D -2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
C  0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
Q -1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
E -1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
G  0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
H -2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
I -1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
L -1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
K -1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
M -1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
F -2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
P -1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
S  1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
W -3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
Y -2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
V  0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
B -2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
Z -1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
X  0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
* -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""

_BLOSUM45 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  5 -2 -1 -2 -1 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -2 -2  0 -1 -1  0 -5
R -2  7  0 -1 -3  1  0 -2  0 -3 -2  3 -1 -2 -2 -1 -1 -2 -1 -2 -1  0 -1 -5
N -1  0  6  2 -2  0  0  0  1 -2 -3  0 -2 -2 -2  1  0 -4 -2 -3  4  0 -1 -5
D -2 -1  2  7 -3  0  2 -1  0 -4 -3  0 -3 -4 -1  0 -1 -4 -2 -3  5  1 -1 -5
C -1 -3 -2 -3 12 -3 -3 -3 -3 -3 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1 -2 -3 -2 -5
Q -1  1  0  0 -3  6  2 -2  1 -2 -2  1  0 -4 -1  0 -1 -2 -1 -3  0  4 -1 -5
E -1  0  0  2 -3  2  6 -2  0 -3 -2  1 -2 -3  0  0 -1 -3 -2 -3  1  4 -1 -5
G  0 -2  0 -1 -3 -2 -2  7 -2 -4 -3 -2 -2 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -5
H -2  0  1  0 -3  1  0 -2 10 -3 -2 -1  0 -2 -2 -1 -2 -3  2 -3  0  0 -1 -5
I -1 -3 -2 -4 -3 -2 -3 -4 -3  5  2 -3  2  0 -2 -2 -1 -2  0  3 -3 -3 -1 -5
L -1 -2 -3 -3 -2 -2 -2 -3 -2  2  5 -3  2  1 -3 -3 -1 -2  0  1 -3 -2 -1 -5
K -1  3  0  0 -3  1  1 -2 -1 -3 -3  5 -1 -3 -1 -1 -1 -2 -1 -2  0  1 -1 -5
M -1 -1 -2 -3 -2  0 -2 -2  0  2  2 -1  6  0 -2 -2 -1 -2  0  1 -2 -1 -1 -5
F -2 -2 -2 -4 -2 -4 -3 -3 -2  0  1 -3  0  8 -3 -2 -1  1  3  0 -3 -3 -1 -5
P -1 -2 -2 -1 -4 -1  0 -2 -2 -2 -3 -1 -2 -3  9 -1 -1 -3 -3 -3 -2 -1 -1 -5
S  1 -1  1  0 -1  0  0  0 -1 -2 -3 -1 -2 -2 -1  4  2 -4 -2 -1  0  0  0 -5
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -1 -1  2  5 -3 -1  0  0 -1  0 -5
W -2 -2 -4 -4 -5 -2 -3 -2 -3 -2 -2 -2 -2  1 -3 -4 -3 15  3 -3 -4 -2 -2 -5
Y -2 -1 -2 -2 -3 -1 -2 -3  2  0  0 -1  0  3 -3 -2 -1  3  8 -1 -2 -2 -1 -5
V  0 -2 -3 -3 -1 -3 -3 -3 -3  3  1 -2  1  0 -3 -1  0 -3 -1  5 -3 -3 -1 -5
B -1 -1  4  5 -2  0  1 -1  0 -3 -3  0 -2 -3 -2  0  0 -4 -2 -3  4  2 -1 -5
Z -1  0  0  1 -3  4  4 -2  0 -3 -2  1 -1 -3 -1  0 -1 -2 -2 -3  2  4 -1 -5
X  0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -2 -1 -1 -1 -1 -1 -5
* -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5  1
"""

_BLOSUM50 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  5 -2 -1 -2 -1 -1 -1  0 -2 -1 -2 -1 -1 -3 -1  1  0 -3 -2  0 -2 -1 -1 -5
R -2  7 -1 -2 -4  1  0 -3  0 -4 -3  3 -2 -3 -3 -1 -1 -3 -1 -3 -1  0 -1 -5
N -1 -1  7  2 -2  0  0  0  1 -3 -4  0 -2 -4 -2  1  0 -4 -2 -3  4  0 -1 -5
D -2 -2  2  8 -4  0  2 -1 -1 -4 -4 -1 -4 -5 -1  0 -1 -5 -3 -4  5  1 -1 -5
C -1 -4 -2 -4 13 -3 -3 -3 -3 -2 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1 -3 -3 -2 -5
Q -1  1  0  0 -3  7  2 -2  1 -3 -2  2  0 -4 -1  0 -1 -1 -1 -3  0  4 -1 -5
E -1  0  0  2 -3  2  6 -3  0 -4 -3  1 -2 -3 -1 -1 -1 -3 -2 -3  1  5 -1 -5
G  0 -3  0 -1 -3 -2 -3  8 -2 -4 -4 -2 -3 -4 -2  0 -2 -3 -3 -4 -1 -2 -2 -5
H -2  0  1 -1 -3  1  0 -2 10 -4 -3  0 -1 -1 -2 -1 -2 -3  2 -4  0  0 -1 -5
I -1 -4 -3 -4 -2 -3 -4 -4 -4  5  2 -3  2  0 -3 -3 -1 -3 -1  4 -4 -3 -1 -5
L -2 -3 -4 -4 -2 -2 -3 -4 -3  2  5 -3  3  1 -4 -3 -1 -2 -1  1 -4 -3 -1 -5
K -1  3  0 -1 -3  2  1 -2  0 -3 -3  6 -2 -4 -1  0 -1 -3 -2 -3  0  1 -1 -5
M -1 -2 -2 -4 -2  0 -2 -3 -1  2  3 -2  7  0 -3 -2 -1 -1  0  1 -3 -1 -1 -5
F -3 -3 -4 -5 -2 -4 -3 -4 -1  0  1 -4  0  8 -4 -3 -2  1  4 -1 -4 -4 -2 -5
P -1 -3 -2 -1 -4 -1 -1 -2 -2 -3 -4 -1 -3 -4 10 -1 -1 -4 -3 -3 -2 -1 -2 -5
S  1 -1  1  0 -1  0 -1  0 -1 -3 -3  0 -2 -3 -1  5  2 -4 -2 -2  0  0 -1 -5
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  2  5 -3 -2  0  0 -1  0 -5
W -3 -3 -4 -5 -5 -1 -3 -3 -3 -3 -2 -3 -1  1 -4 -4 -3 15  2 -3 -5 -2 -3 -5
Y -2 -1 -2 -3 -3 -1 -2 -3  2 -1 -1 -2  0  4 -3 -2 -2  2  8 -1 -3 -2 -1 -5
V  0 -3 -3 -4 -1 -3 -3 -4 -4  4  1 -3  1 -1 -3 -2  0 -3 -1  5 -4 -3 -1 -5
B -2 -1  4  5 -3  0  1 -1  0 -4 -4  0 -3 -4 -2  0  0 -5 -3 -4  5  2 -1 -5
Z -1  0  0  1 -3  4  5 -2  0 -3 -3  1 -1 -4 -1  0 -1 -2 -2 -3  2  5 -1 -5
X -1 -1 -1 -1 -2 -1 -1 -2 -1 -1 -1 -1 -1 -2 -2 -1  0 -3 -1 -1 -1 -1 -1 -5
* -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5  1
"""

_BLOSUM80 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  5 -2 -2 -2 -1 -1 -1  0 -2 -2 -2 -1 -1 -3 -1  1  0 -3 -2  0 -2 -1 -1 -6
R -2  6 -1 -2 -4  1 -1 -3  0 -3 -3  2 -2 -4 -2 -1 -1 -4 -3 -3 -1  0 -1 -6
N -2 -1  6  1 -3  0 -1 -1  0 -4 -4  0 -3 -4 -3  0  0 -4 -3 -4  5  0 -1 -6
D -2 -2  1  6 -4 -1  1 -2 -2 -4 -5 -1 -4 -4 -2 -1 -1 -6 -4 -4  5  1 -1 -6
C -1 -4 -3 -4  9 -4 -5 -4 -4 -2 -2 -4 -2 -3 -4 -2 -1 -3 -3 -1 -4 -4 -1 -6
Q -1  1  0 -1 -4  6  2 -2  1 -3 -3  1  0 -4 -2  0 -1 -3 -2 -3  0  4 -1 -6
E -1 -1 -1  1 -5  2  6 -3  0 -4 -4  1 -2 -4 -2  0 -1 -4 -3 -3  1  5 -1 -6
G  0 -3 -1 -2 -4 -2 -3  6 -3 -5 -4 -2 -4 -4 -3 -1 -2 -4 -4 -4 -1 -3 -1 -6
H -2  0  0 -2 -4  1  0 -3  8 -4 -3 -1 -2 -2 -3 -1 -2 -3  2 -4 -1  0 -1 -6
I -2 -3 -4 -4 -2 -3 -4 -5 -4  5  1 -3  1 -1 -4 -3 -1 -3 -2  3 -4 -4 -1 -6
L -2 -3 -4 -5 -2 -3 -4 -4 -3  1  4 -3  2  0 -3 -3 -2 -2 -2  1 -4 -3 -1 -6
K -1  2  0 -1 -4  1  1 -2 -1 -3 -3  5 -2 -4 -1 -1 -1 -4 -3 -3 -1  1 -1 -6
M -1 -2 -3 -4 -2  0 -2 -4 -2  1  2 -2  6  0 -3 -2 -1 -2 -2  1 -3 -1 -1 -6
F -3 -4 -4 -4 -3 -4 -4 -4 -2 -1  0 -4  0  6 -4 -3 -2  0  3 -1 -4 -4 -1 -6
P -1 -2 -3 -2 -4 -2 -2 -3 -3 -4 -3 -1 -3 -4  8 -1 -2 -5 -4 -3 -2 -2 -1 -6
S  1 -1  0 -1 -2  0  0 -1 -1 -3 -3 -1 -2 -3 -1  5  1 -4 -2 -2  0  0 -1 -6
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -2 -1 -1 -2 -2  1  5 -4 -2  0 -1 -1 -1 -6
W -3 -4 -4 -6 -3 -3 -4 -4 -3 -3 -2 -4 -2  0 -5 -4 -4 11  2 -3 -5 -4 -1 -6
Y -2 -3 -3 -4 -3 -2 -3 -4  2 -2 -2 -3 -2  3 -4 -2 -2  2  7 -2 -3 -3 -1 -6
V  0 -3 -4 -4 -1 -3 -3 -4 -4  3  1 -3  1 -1 -3 -2  0 -3 -2  4 -4 -3 -1 -6
B -2 -1  5  5 -4  0  1 -1 -1 -4 -4 -1 -3 -4 -2  0 -1 -5 -3 -4  5  0 -1 -6
Z -1  0  0  1 -4  4  5 -3  0 -4 -3  1 -1 -4 -2  0 -1 -4 -3 -3  0  5 -1 -6
X -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -6
* -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6  1
"""

_BLOSUM90 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  5 -2 -2 -3 -1 -1 -1  0 -2 -2 -2 -1 -2 -3 -1  1  0 -4 -3 -1 -2 -1 -1 -6
R -2  6 -1 -3 -5  1 -1 -3  0 -4 -3  2 -2 -4 -3 -1 -2 -4 -3 -3 -2  0 -2 -6
N -2 -1  7  1 -4  0 -1 -1  0 -4 -4  0 -3 -4 -3  0  0 -5 -3 -4  4 -1 -2 -6
D -3 -3  1  7 -5 -1  1 -2 -2 -5 -5 -1 -4 -5 -3 -1 -2 -6 -4 -5  4  0 -2 -6
C -1 -5 -4 -5  9 -4 -6 -4 -5 -2 -2 -4 -2 -3 -4 -2 -2 -4 -4 -2 -4 -5 -3 -6
Q -1  1  0 -1 -4  7  2 -3  1 -4 -3  1  0 -4 -2 -1 -1 -3 -3 -3 -1  4 -1 -6
E -1 -1 -1  1 -6  2  6 -3 -1 -4 -4  0 -3 -5 -2 -1 -1 -5 -4 -3  0  4 -2 -6
G  0 -3 -1 -2 -4 -3 -3  6 -3 -5 -5 -2 -4 -5 -3 -1 -3 -4 -5 -5 -2 -3 -2 -6
H -2  0  0 -2 -5  1 -1 -3  8 -4 -4 -1 -3 -2 -3 -2 -2 -3  1 -4 -1  0 -2 -6
I -2 -4 -4 -5 -2 -4 -4 -5 -4  5  1 -4  1 -1 -4 -3 -1 -4 -2  3 -5 -4 -2 -6
L -2 -3 -4 -5 -2 -3 -4 -5 -4  1  5 -3  2  0 -4 -3 -2 -3 -2  0 -5 -4 -2 -6
K -1  2  0 -1 -4  1  0 -2 -1 -4 -3  6 -2 -4 -2 -1 -1 -5 -3 -3 -1  1 -1 -6
M -2 -2 -3 -4 -2  0 -3 -4 -3  1  2 -2  7 -1 -3 -2 -1 -2 -2  0 -4 -2 -1 -6
F -3 -4 -4 -5 -3 -4 -5 -5 -2 -1  0 -4 -1  7 -4 -3 -3  0  3 -2 -4 -4 -2 -6
P -1 -3 -3 -3 -4 -2 -2 -3 -3 -4 -4 -2 -3 -4  8 -2 -2 -5 -4 -3 -3 -2 -2 -6
S  1 -1  0 -1 -2 -1 -1 -1 -2 -3 -3 -1 -2 -3 -2  5  1 -4 -3 -2  0 -1 -1 -6
T  0 -2  0 -2 -2 -1 -1 -3 -2 -1 -2 -1 -1 -3 -2  1  6 -4 -2 -1 -1 -1 -1 -6
W -4 -4 -5 -6 -4 -3 -5 -4 -3 -4 -3 -5 -2  0 -5 -4 -4 11  2 -3 -6 -4 -3 -6
Y -3 -3 -3 -4 -4 -3 -4 -5  1 -2 -2 -3 -2  3 -4 -3 -2  2  8 -3 -4 -3 -2 -6
V -1 -3 -4 -5 -2 -3 -3 -5 -4  3  0 -3  0 -2 -3 -2 -1 -3 -3  5 -4 -3 -2 -6
B -2 -2  4  4 -4 -1  0 -2 -1 -5 -5 -1 -4 -4 -3  0 -1 -6 -4 -4  4  0 -2 -6
Z -1  0 -1  0 -5  4  4 -3  0 -4 -4  1 -2 -4 -2 -1 -1 -4 -3 -3  0  4 -2 -6
X -1 -2 -2 -2 -3 -1 -2 -2 -2 -2 -2 -1 -1 -2 -2 -1 -1 -3 -2 -2 -2 -2 -2 -6
* -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6  1
"""

_PAM250 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  2 -2  0  0 -2  0  0  1 -1 -1 -2 -1 -1 -3  1  1  1 -6 -3  0  0  0  0 -8
R -2  6  0 -1 -4  1 -1 -3  2 -2 -3  3  0 -4  0  0 -1  2 -4 -2 -1  0 -1 -8
N  0  0  2  2 -4  1  1  0  2 -2 -3  1 -2 -3  0  1  0 -4 -2 -2  2  1  0 -8
D  0 -1  2  4 -5  2  3  1  1 -2 -4  0 -3 -6 -1  0  0 -7 -4 -2  3  3 -1 -8
C -2 -4 -4 -5 12 -5 -5 -3 -3 -2 -6 -5 -5 -4 -3  0 -2 -8  0 -2 -4 -5 -3 -8
Q  0  1  1  2 -5  4  2 -1  3 -2 -2  1 -1 -5  0 -1 -1 -5 -4 -2  1  3 -1 -8
E  0 -1  1  3 -5  2  4  0  1 -2 -3  0 -2 -5 -1  0  0 -7 -4 -2  3  3 -1 -8
G  1 -3  0  1 -3 -1  0  5 -2 -3 -4 -2 -3 -5  0  1  0 -7 -5 -1  0  0 -1 -8
H -1  2  2  1 -3  3  1 -2  6 -2 -2  0 -2 -2  0 -1 -1 -3  0 -2  1  2 -1 -8
I -1 -2 -2 -2 -2 -2 -2 -3 -2  5  2 -2  2  1 -2 -1  0 -5 -1  4 -2 -2 -1 -8
L -2 -3 -3 -4 -6 -2 -3 -4 -2  2  6 -3  4  2 -3 -3 -2 -2 -1  2 -3 -3 -1 -8
K -1  3  1  0 -5  1  0 -2  0 -2 -3  5  0 -5 -1  0  0 -3 -4 -2  1  0 -1 -8
M -1  0 -2 -3 -5 -1 -2 -3 -2  2  4  0  6  0 -2 -2 -1 -4 -2  2 -2 -2 -1 -8
F -3 -4 -3 -6 -4 -5 -5 -5 -2  1  2 -5  0  9 -5 -3 -3  0  7 -1 -4 -5 -2 -8
P  1  0  0 -1 -3  0 -1  0  0 -2 -3 -1 -2 -5  6  1  0 -6 -5 -1 -1  0 -1 -8
S  1  0  1  0  0 -1  0  1 -1 -1 -3  0 -2 -3  1  2  1 -2 -3 -1  0  0  0 -8
T  1 -1  0  0 -2 -1  0  0 -1  0 -2  0 -1 -3  0  1  3 -5 -3  0  0 -1  0 -8
W -6  2 -4 -7 -8 -5 -7 -7 -3 -5 -2 -3 -4  0 -6 -2 -5 17  0 -6 -5 -6 -4 -8
Y -3 -4 -2 -4  0 -4 -4 -5  0 -1 -1 -4 -2  7 -5 -3 -3  0 10 -2 -3 -4 -2 -8
V  0 -2 -2 -2 -2 -2 -2 -1 -2  4  2 -2  2 -1 -1 -1  0 -6 -2  4 -2 -2 -1 -8
B  0 -1  2  3 -4  1  3  0  1 -2 -3  1 -2 -4 -1  0  0 -5 -3 -2  3  2 -1 -8
Z  0  0  1  3 -5  3  3  0  2 -2 -3  0 -2 -5  0  0 -1 -6 -4 -2  2  3 -1 -8
X  0 -1  0 -1 -3 -1 -1 -1 -1 -1 -1 -1 -1 -2 -1  0  0 -4 -2 -1 -1 -1 -1 -8
* -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8  1
"""

_PAM70 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  5 -4 -2 -1 -4 -2 -1  0 -4 -2 -4 -4 -3 -6  0  1  1 -9 -5 -1 -1 -1 -2 -11
R -4  8 -3 -6 -5  0 -5 -6  0 -3 -6  2 -2 -7 -2 -1 -4  0 -7 -5 -4 -2 -3 -11
N -2 -3  6  3 -7 -1  0 -1  1 -3 -5  0 -5 -6 -3  1  0 -6 -3 -5  5 -1 -2 -11
D -1 -6  3  6 -9  0  3 -1 -1 -5 -8 -2 -7 -10 -4 -1 -2 -10 -7 -5  5  2 -3 -11
C -4 -5 -7 -9  9 -9 -9 -6 -5 -4 -10 -9 -9 -8 -5 -1 -5 -11 -2 -4 -8 -9 -6 -11
Q -2  0 -1  0 -9  7  2 -4  2 -5 -3 -1 -2 -9 -1 -3 -3 -8 -8 -4 -1  5 -2 -11
E -1 -5  0  3 -9  2  6 -2 -2 -4 -6 -2 -4 -9 -3 -2 -3 -11 -6 -4  2  5 -3 -11
G  0 -6 -1 -1 -6 -4 -2  6 -6 -6 -7 -5 -6 -7 -3  0 -3 -10 -9 -3 -1 -3 -3 -11
H -4  0  1 -1 -5  2 -2 -6  8 -6 -4 -3 -6 -4 -2 -3 -4 -5 -1 -4  0  1 -3 -11
I -2 -3 -3 -5 -4 -5 -4 -6 -6  7  1 -4  1  0 -5 -4 -1 -9 -4  3 -4 -4 -3 -11
L -4 -6 -5 -8 -10 -3 -6 -7 -4  1  6 -5  2 -1 -5 -6 -4 -4 -4  0 -6 -4 -4 -11
K -4  2  0 -2 -9 -1 -2 -5 -3 -4 -5  6  0 -9 -4 -2 -1 -7 -7 -6 -1 -2 -3 -11
M -3 -2 -5 -7 -9 -2 -4 -6 -6  1  2  0 10 -2 -5 -3 -2 -8 -7  0 -6 -3 -3 -11
F -6 -7 -6 -10 -8 -9 -9 -7 -4  0 -1 -9 -2  8 -7 -4 -6 -2  4 -5 -7 -9 -5 -11
P  0 -2 -3 -4 -5 -1 -3 -3 -2 -5 -5 -4 -5 -7  7  0 -2 -9 -9 -3 -4 -2 -3 -11
S  1 -1  1 -1 -1 -3 -2  0 -3 -4 -6 -2 -3 -4  0  5  2 -3 -5 -3  0 -2 -1 -11
T  1 -4  0 -2 -5 -3 -3 -3 -4 -1 -4 -1 -2 -6 -2  2  6 -8 -4 -1 -1 -3 -2 -11
W -9  0 -6 -10 -11 -8 -11 -10 -5 -9 -4 -7 -8 -2 -9 -3 -8 13 -3 -10 -7 -10 -7 -11
Y -5 -7 -3 -7 -2 -8 -6 -9 -1 -4 -4 -7 -7  4 -9 -5 -4 -3  9 -5 -4 -7 -5 -11
V -1 -5 -5 -5 -4 -4 -4 -3 -4  3  0 -6  0 -5 -3 -3 -1 -10 -5  6 -5 -4 -2 -11
B -1 -4  5  5 -8 -1  2 -1  0 -4 -6 -1 -6 -7 -4  0 -1 -7 -4 -5  5  1 -2 -11
Z -1 -2 -1  2 -9  5  5 -3  1 -4 -4 -2 -3 -9 -2 -2 -3 -10 -7 -4  1  5 -3 -11
X -2 -3 -2 -3 -6 -2 -3 -3 -3 -3 -4 -3 -3 -5 -3 -1 -2 -7 -5 -2 -2 -3 -3 -11
* -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 1
"""

_PAM30 = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  6 -7 -4 -3 -6 -4 -2 -2 -7 -5 -6 -7 -5 -8 -2  0 -1 -13 -8 -2 -3 -3 -3 -17
R -7  8 -6 -10 -8 -2 -9 -9 -2 -5 -8  0 -4 -9 -4 -3 -6 -2 -10 -8 -7 -4 -6 -17
N -4 -6  8  2 -11 -3 -2 -3  0 -5 -7 -1 -9 -9 -6  0 -2 -8 -4 -8  6 -3 -3 -17
D -3 -10  2  8 -14 -2  2 -3 -4 -7 -12 -4 -11 -15 -8 -4 -5 -15 -11 -8  6  1 -5 -17
C -6 -8 -11 -14 10 -14 -14 -9 -7 -6 -15 -14 -13 -13 -8 -3 -8 -15 -4 -6 -12 -14 -9 -17
Q -4 -2 -3 -2 -14  8  1 -7  1 -8 -5 -3 -4 -13 -3 -5 -5 -13 -12 -7 -3  6 -5 -17
E -2 -9 -2  2 -14  1  8 -4 -5 -5 -9 -4 -7 -14 -5 -4 -6 -17 -8 -6  1  6 -5 -17
G -2 -9 -3 -3 -9 -7 -4  6 -9 -11 -10 -7 -8 -9 -6 -2 -6 -15 -14 -5 -3 -5 -5 -17
H -7 -2  0 -4 -7  1 -5 -9  9 -9 -6 -6 -10 -6 -4 -6 -7 -7 -3 -6 -1 -1 -5 -17
I -5 -5 -5 -7 -6 -8 -5 -11 -9  8 -1 -6 -1 -2 -8 -7 -2 -14 -6  2 -6 -6 -5 -17
L -6 -8 -7 -12 -15 -5 -9 -10 -6 -1  7 -8  1 -3 -7 -8 -7 -6 -7 -2 -9 -7 -6 -17
K -7  0 -1 -4 -14 -3 -4 -7 -6 -6 -8  7 -2 -14 -6 -4 -3 -12 -9 -9 -2 -4 -5 -17
M -5 -4 -9 -11 -13 -4 -7 -8 -10 -1  1 -2 11 -4 -8 -5 -4 -13 -11 -1 -10 -5 -5 -17
F -8 -9 -9 -15 -13 -13 -14 -9 -6 -2 -3 -14 -4  9 -10 -6 -9 -4  2 -8 -10 -13 -8 -17
P -2 -4 -6 -8 -8 -3 -5 -6 -4 -8 -7 -6 -8 -10  8 -2 -4 -14 -13 -6 -7 -4 -5 -17
S  0 -3  0 -4 -3 -5 -4 -2 -6 -7 -8 -4 -5 -6 -2  6  0 -5 -7 -6 -1 -5 -3 -17
T -1 -6 -2 -5 -8 -5 -6 -6 -7 -2 -7 -3 -4 -9 -4  0  7 -13 -6 -3 -3 -6 -4 -17
W -13 -2 -8 -15 -15 -13 -17 -15 -7 -14 -6 -12 -13 -4 -14 -5 -13 13 -5 -15 -10 -14 -11 -17
Y -8 -10 -4 -11 -4 -12 -8 -14 -3 -6 -7 -9 -11  2 -13 -7 -6 -5 10 -7 -6 -9 -7 -17
V -2 -8 -8 -8 -6 -7 -6 -5 -6  2 -2 -9 -1 -8 -6 -6 -3 -15 -7  7 -8 -6 -5 -17
B -3 -7  6  6 -12 -3  1 -3 -1 -6 -9 -2 -10 -10 -7 -1 -3 -10 -6 -8  6  0 -5 -17
Z -3 -4 -3  1 -14  6  6 -5 -1 -6 -7 -4 -5 -13 -4 -5 -6 -14 -9 -6  0  6 -5 -17
X -3 -6 -3 -5 -9 -5 -5 -5 -5 -5 -6 -5 -5 -8 -5 -3 -4 -11 -7 -5 -5 -5 -5 -17
* -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 1
"""

_BUILTIN_TEXT = {
    "BLOSUM45": _BLOSUM45,
    "BLOSUM50": _BLOSUM50,
    "BLOSUM62": _BLOSUM62,
    "BLOSUM80": _BLOSUM80,
    "BLOSUM90": _BLOSUM90,
    "PAM30": _PAM30,
    "PAM70": _PAM70,
    "PAM250": _PAM250,
}

BUILTIN_NAMES = tuple(sorted(_BUILTIN_TEXT))


# ---------------------------------------------------------------------------
# ScoreMatrix
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScoreMatrix:
    """A substitution matrix mapped onto this engine's internal code space.

    ``scores[a, b]`` is the substitution score for internal codes ``a, b``
    over the alphabet given by ``symtype``. ``padded()`` returns the
    kernel-side (PADDED_ALPHABET x PADDED_ALPHABET) int32 table; pad rows and
    columns score a large negative so padding symbols can never improve an
    alignment.
    """

    name: str
    symtype: SymType
    scores: np.ndarray  # (A, A) int32, symmetric for the builtins

    def __post_init__(self):
        s = self.scores
        if s.ndim != 2 or s.shape[0] != s.shape[1]:
            raise ValueError(f"score matrix must be square, got {s.shape}")
        if s.shape[0] > PADDED_ALPHABET:
            raise ValueError(f"alphabet too large: {s.shape[0]} > {PADDED_ALPHABET}")

    @property
    def alphabet_size(self) -> int:
        return self.scores.shape[0]

    def padded(self, pad_value: int = -64) -> np.ndarray:
        """(PADDED_ALPHABET, PADDED_ALPHABET) int32 table for the kernels.

        ``pad_value`` must be representable in int8 (the one-hot dot path
        keeps an int8 copy) and negative enough that a run of pad symbols can
        never out-score a real residue pairing.
        """
        out = np.full((PADDED_ALPHABET, PADDED_ALPHABET), pad_value, dtype=np.int32)
        a = self.alphabet_size
        out[:a, :a] = self.scores
        return out

    def score(self, a: int, b: int) -> int:
        return int(self.scores[a, b])


def _parse_ncbi(text: str, name: str, symtype: SymType, alphabet: str) -> ScoreMatrix:
    mat, order = parse_matrix_file(io.StringIO(text))
    # Re-map from file column order onto our internal code order.
    idx = [order.index(c) for c in alphabet]
    scores = mat[np.ix_(idx, idx)]
    return ScoreMatrix(name=name, symtype=symtype, scores=scores)


def parse_matrix_file(fh) -> tuple[np.ndarray, str]:
    """Parse an NCBI-format substitution matrix file.

    Equivalent of the reference's matrix-from-file mode
    (``mat_init_from_file``, SURVEY.md §2). Returns (matrix, column order
    string). Lines starting with ``#`` are comments; the first non-comment
    line is the column header.
    """
    order: list[str] = []
    rows: dict[str, list[int]] = {}
    for line in fh:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if not order:
            if any(len(p) != 1 for p in parts):
                raise ValueError(f"bad matrix header line: {line!r}")
            order = parts
            continue
        sym, vals = parts[0], parts[1:]
        if len(sym) != 1 or len(vals) != len(order):
            raise ValueError(f"bad matrix row: {line!r}")
        rows[sym] = [int(v) for v in vals]
    if not order or not rows:
        raise ValueError("empty matrix file")
    if set(rows) != set(order):
        raise ValueError("matrix rows do not match header columns")
    mat = np.array([rows[c] for c in order], dtype=np.int32)
    return mat, "".join(order)


def builtin(name: str) -> ScoreMatrix:
    """Load a built-in matrix (reference: ``mat_init_buildin``)."""
    key = name.upper()
    if key not in _BUILTIN_TEXT:
        raise ValueError(f"unknown builtin matrix {name!r}; have {BUILTIN_NAMES}")
    return _parse_ncbi(_BUILTIN_TEXT[key], key, SymType.AMINOACID, AA_ALPHABET)


def from_file(path: str, symtype: SymType = SymType.AMINOACID) -> ScoreMatrix:
    """Load a matrix from an NCBI-format file (``mat_init_from_file``)."""
    alphabet = AA_ALPHABET if symtype is SymType.AMINOACID else NT_ALPHABET
    with open(path) as fh:
        mat, order = parse_matrix_file(fh)
    known = [c for c in alphabet if c in order]
    if not known:
        raise ValueError(f"matrix file shares no symbols with {symtype} alphabet")
    # Unknown-to-the-file symbols keep a mild mismatch of the file's minimum.
    a = len(alphabet)
    scores = np.full((a, a), int(mat.min()), dtype=np.int32)
    for ci in known:
        for cj in known:
            scores[alphabet.index(ci), alphabet.index(cj)] = mat[
                order.index(ci), order.index(cj)
            ]
    return ScoreMatrix(name=path, symtype=symtype, scores=scores)


def constant_scoring(
    match: int, mismatch: int, symtype: SymType = SymType.NUCLEOTIDE
) -> ScoreMatrix:
    """Constant match/mismatch scoring (``mat_init_constant_scoring``).

    Exact-symbol equality scores ``match``; everything else ``mismatch``.
    Ambiguity codes only match themselves, mirroring simple constant-scoring
    semantics (no partial IUPAC credit).
    """
    if mismatch > match:
        raise ValueError("mismatch score must not exceed match score")
    alphabet = AA_ALPHABET if symtype is SymType.AMINOACID else NT_ALPHABET
    a = len(alphabet)
    scores = np.full((a, a), mismatch, dtype=np.int32)
    np.fill_diagonal(scores, match)
    return ScoreMatrix(name=f"const({match},{mismatch})", symtype=symtype, scores=scores)
