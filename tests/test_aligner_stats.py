"""Aligner-stage observability.

ALIGNMENT-mode work runs outside the search stage's stats window: these
tests pin the ``aligner_seconds`` / ``aligner_cells`` accounting end to
end, on database hits and on the 1-vs-1 entry point.
"""
from libssa_tpu.api import SSAContext
from libssa_tpu.constants import (
    AlignType,
    ComputeMode,
    Strand,
    SymType,
)
from libssa_tpu.io import fasta
from libssa_tpu.search.manager import SearchStats


def test_alignment_mode_search_accounts_traceback(tmp_path):
    """mode=ALIGNMENT search stats carry aligner seconds + cells."""
    recs = [
        ("a", "MKVLAAGIVGWKQTERNDCFYHH"),
        ("b", "AAGIVGWKQTE"),
        ("c", "PPPPPPPPWWPPPPP"),
    ]
    db_path = tmp_path / "db.fas"
    fasta.write_fasta(str(db_path), recs)
    c = SSAContext()
    c.init_symbol_translation(SymType.AMINOACID, Strand.FORWARD, 1, 1)
    c.init_score_matrix("BLOSUM62")
    c.init_gap_penalties(10, 1)
    c.init_db_fasta(str(db_path))
    q = c.init_sequence_fasta(recs[0][1])
    got = c.sw_align(q, k=2, mode=ComputeMode.ALIGNMENT)
    assert len(got) == 2
    m = len(recs[0][1])
    want_cells = sum(
        m * len(recs[h.seq_id][1]) for h in got
    )
    assert got.stats.aligner_cells == want_cells
    assert got.stats.aligner_seconds > 0.0
    # SCORE mode does no traceback work at all.
    score_only = c.sw_align(q, k=2, mode=ComputeMode.SCORE)
    assert score_only.stats.aligner_cells == 0
    assert score_only.stats.aligner_seconds == 0.0


def test_client_align_pair_carries_stats():
    """The 1-vs-1 entry point reports stats on the returned Alignment."""
    c = SSAContext()
    c.init_symbol_translation(SymType.AMINOACID, Strand.FORWARD, 1, 1)
    c.init_score_matrix("BLOSUM62")
    c.init_gap_penalties(10, 1)
    q = c.init_sequence_fasta("MKVLAAGIVGWKQTERNDCFYHH")
    subject = "DDDDMKVLAAGIVGWKQTERNDCFYHHEEEE"
    got = c.align_pair(q, subject, AlignType.SW, ComputeMode.ALIGNMENT)
    assert got.stats is not None
    assert got.stats.aligner_cells == 23 * len(subject)
    assert got.stats.aligner_seconds > 0.0
    scored = c.align_pair(q, subject, AlignType.SW, ComputeMode.SCORE)
    assert scored.stats is not None
    assert scored.stats.cells == 23 * len(subject)
    assert scored.stats.dispatches == 1
    assert scored.stats.seconds > 0.0
    assert scored.score == got.score


def test_stats_merge_carries_aligner_fields():
    a, b = SearchStats(), SearchStats()
    b.aligner_seconds = 1.5
    b.aligner_cells = 1000
    a.merge(b)
    assert a.aligner_seconds == 1.5
    assert a.aligner_cells == 1000
