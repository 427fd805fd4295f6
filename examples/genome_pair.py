"""Genome-scale pairwise alignment: the single-enormous-pair path.

The classic long-pair workload is two DNA sequences (contigs,
mitochondrial genomes, viral isolates) scored/aligned as ONE optimal
Gotoh alignment — no database, no chunking. This walks the dedicated
machinery:

  * score-only on the device (``ops/longpair``, the O(n)-state row-sweep
    scan),
  * full traceback in O(m+n) memory (Myers-Miller host passes with the
    native leaf solver, ``search/hirschberg.py``),
  * and a pair can span a whole device mesh (``parallel/ring.py``).

Run on any backend:  python examples/genome_pair.py [length]
(defaults to 16384; the CPU backend is slow at that size — this demo is
sized for a GPU.)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import libssa_tpu.api as ssa
from libssa_tpu.constants import AlignType, ComputeMode, SymType

N = int(sys.argv[1]) if len(sys.argv) > 1 else 16384

# Two related "genomes": a sequence and a mutated copy (5% substitutions,
# a handful of indels) — enough homology for a long central alignment.
rng = np.random.default_rng(0)
a = rng.choice(list("ACGT"), N)
b = a.copy()
sub = rng.random(N) < 0.05
b[sub] = rng.choice(list("ACGT"), int(sub.sum()))
cut = rng.integers(0, N - 50, 8)
keep = np.ones(N, bool)
for c in cut:
    keep[c : c + int(rng.integers(3, 30))] = False
qs, ss = "".join(a), "".join(b[keep])

ssa.init_symbol_translation(SymType.NUCLEOTIDE)
ssa.init_constant_scoring(2, -3)  # classic megablast-style scoring
ssa.init_gap_penalties(5, 2)
q = ssa.init_sequence_fasta(">genomeA\n" + qs)

# -- 1. Score only: the kernel-rate path ------------------------------------
t0 = time.perf_counter()
hit = ssa.align_pair(q, ss, align_type=AlignType.SW, mode=ComputeMode.SCORE)
warm = time.perf_counter() - t0
t0 = time.perf_counter()
hit = ssa.align_pair(q, ss, align_type=AlignType.SW, mode=ComputeMode.SCORE)
dt = time.perf_counter() - t0
cells = len(qs) * len(ss)
print(f"SW score {hit.score}  ({len(qs)} x {len(ss)} = {cells/1e9:.2f} Gcells; "
      f"warm {dt*1e3:.0f} ms = {cells/dt/1e9:.1f} GCUPS incl. dispatch, "
      f"first call {warm:.1f}s with compile)")

# -- 2. Full optimal traceback in O(m+n) memory ------------------------------
t0 = time.perf_counter()
aln = ssa.align_pair(q, ss, align_type=AlignType.SW, mode=ComputeMode.ALIGNMENT)
dt = time.perf_counter() - t0
ident = aln.aligned[1].count("|") / max(1, len(aln.aligned[1]))
print(f"traceback: score {aln.score} q[{aln.q_begin}:{aln.q_end}] "
      f"s[{aln.s_begin}:{aln.s_end}] identity {ident:.1%} "
      f"cigar {len(aln.cigar)} chars  ({dt:.1f}s)")
assert aln.score == hit.score, "traceback score must equal the kernel score"

ssa.ssa_exit()
