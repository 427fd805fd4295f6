"""libssa_tpu — an accelerator-native optimal sequence-alignment engine.

A from-scratch JAX/Pallas re-design of the capabilities of the reference
C/SIMD library (xubo245/libssa, surveyed in SURVEY.md): Smith-Waterman and
Needleman-Wunsch alignment with affine gaps, BLOSUM/PAM substitution
matrices, adaptive-precision database search with top-k hit lists,
traceback alignment, and sharded search over device meshes.
"""

from .constants import (
    AlignType,
    BitWidth,
    ComputeMode,
    OutputMode,
    Strand,
    SymType,
)

__version__ = "0.1.0"

__all__ = [
    "AlignType",
    "BitWidth",
    "ComputeMode",
    "OutputMode",
    "Strand",
    "SymType",
    "__version__",
]
