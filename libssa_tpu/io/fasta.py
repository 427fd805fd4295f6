"""FASTA reading.

Replacement for the reference's external FASTA library ("libsdb",
wrapped by ``src/db_adapter.c`` — SURVEY.md §2 "External DB + adapter").
The hot-path packer has a native C++ implementation (``io/native.py``); this
module is the pure-Python reference parser and the API everything calls.
"""
from __future__ import annotations

import io
import os
from collections.abc import Iterator

import numpy as np

from ..alphabet import encode
from ..constants import SymType


def iter_fasta(path_or_text: str) -> Iterator[tuple[str, str]]:
    """Yield (header, sequence) records from a FASTA file or literal text.

    ``path_or_text`` is treated as a path if it exists on disk, otherwise as
    FASTA-formatted text (mirrors the reference's READ_FROM_FILE vs
    READ_FROM_STRING query modes, applied uniformly).
    """
    if os.path.exists(path_or_text):
        fh = open(path_or_text)
    else:
        if not path_or_text.lstrip().startswith(">"):
            raise FileNotFoundError(
                f"{path_or_text!r} is neither an existing file nor FASTA text"
            )
        fh = io.StringIO(path_or_text)
    with fh:
        header = None
        chunks: list[str] = []
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:].strip()
                chunks = []
            elif header is None:
                raise ValueError("FASTA record body before first '>' header")
            else:
                chunks.append(line)
        if header is not None:
            yield header, "".join(chunks)


def read_fasta_encoded(
    path_or_text: str, symtype: SymType
) -> tuple[list[str], list[np.ndarray]]:
    """Read and translate all records to internal codes."""
    headers: list[str] = []
    seqs: list[np.ndarray] = []
    for h, s in iter_fasta(path_or_text):
        headers.append(h)
        seqs.append(encode(s, symtype))
    return headers, seqs


def write_fasta(path: str, records: list[tuple[str, str]], width: int = 60) -> None:
    """Write records as FASTA (used by tests and the DB cache tooling)."""
    with open(path, "w") as fh:
        for header, seq in records:
            fh.write(f">{header}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
