"""Command-line interface for database search and pairwise alignment.

The reference is a pure library with no CLI (SURVEY.md §1); this thin
wrapper over ``libssa_tpu.api`` covers the build plan's CLI step
(SURVEY.md §7 item 7) so the engine is usable without writing Python:

    python -m libssa_tpu.cli search --db db.fas --query q.fas \
        --matrix BLOSUM62 --gap-open 10 --gap-extend 1 --algo sw -k 10 --align
    python -m libssa_tpu.cli pair --query q.fas --subject s.fas --algo nw
    python -m libssa_tpu.cli info --db db.fas
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .constants import AlignType, BitWidth, ComputeMode, Strand, SymType


def _add_scoring_args(p: argparse.ArgumentParser):
    p.add_argument("--matrix", default="BLOSUM62",
                   help="builtin name or NCBI-format matrix file")
    p.add_argument("--match", type=int, default=None,
                   help="constant match score (with --mismatch, overrides --matrix)")
    p.add_argument("--mismatch", type=int, default=None)
    p.add_argument("--gap-open", type=int, default=10)
    p.add_argument("--gap-open-only", action="store_true",
                   help="gap convention: first gap residue costs open alone "
                        "(default: open + extend)")
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--symtype", choices=["aa", "nt"], default="aa",
                   help="query alphabet")
    p.add_argument("--db-symtype", choices=["aa", "nt"], default=None,
                   help="database alphabet (default: same as --symtype)")
    p.add_argument("--strands", choices=["forward", "reverse", "both"],
                   default="forward")
    p.add_argument("--q-gencode", type=int, default=1)
    p.add_argument("--d-gencode", type=int, default=1)
    p.add_argument("--algo", choices=["sw", "nw"], default="sw")
    p.add_argument("--devices", type=int, default=None,
                   help="shard the DB over an N-device mesh (0 = all); "
                        "results identical to single-device")
    p.add_argument("--platform", choices=["auto", "cpu", "gpu"], default="auto",
                   help="pin the JAX backend (cpu = run anywhere; results "
                        "are bit-identical across backends)")


def _symtype(s):
    return SymType.AMINOACID if s == "aa" else SymType.NUCLEOTIDE


def _configure(args):
    platform = getattr(args, "platform", "auto")
    if platform != "auto":
        # Must land before the first computation; jax.config works even
        # after `import jax`.
        import jax

        jax.config.update("jax_platforms", platform)

    from .api import SSAContext

    ctx = SSAContext()
    ctx.init_symbol_translation(
        _symtype(args.symtype),
        {"forward": Strand.FORWARD, "reverse": Strand.REVERSE, "both": Strand.BOTH}[
            args.strands
        ],
        args.q_gencode,
        args.d_gencode,
        db_symtype=_symtype(args.db_symtype) if args.db_symtype else None,
    )
    if args.match is not None and args.mismatch is not None:
        ctx.init_constant_scoring(args.match, args.mismatch)
    else:
        ctx.init_score_matrix(args.matrix)
    ctx.init_gap_penalties(
        args.gap_open, args.gap_extend,
        first_residue_opens=not getattr(args, "gap_open_only", False),
    )
    # Every subcommand that takes --devices honors it (pair included).
    if getattr(args, "devices", None) is not None:
        ctx.set_device_count(args.devices)
    return ctx


def _print_hit(h, idx: int, show_alignment: bool):
    frame = f" db_frame={h.db_frame}" if h.db_frame else ""
    print(f"{idx:3d}. #{h.seq_id:<7d} score={h.score:<7d} strand={h.strand}{frame}  {h.header}")
    if show_alignment and h.aligned:
        q_row, mid, s_row = h.aligned
        print(f"     Q {h.q_begin:>6d} {q_row} {h.q_end}")
        print(f"     {'':>8s}{mid}")
        print(f"     S {h.s_begin:>6d} {s_row} {h.s_end}")


def _hit_json(hits, header, cells, dt):
    out = [
        {
            "rank": i + 1,
            "seq_id": h.seq_id,
            "header": h.header,
            "score": h.score,
            "strand": h.strand,
            "db_frame": h.db_frame,
            "cigar": h.cigar,
            "q_range": [h.q_begin, h.q_end] if h.q_begin is not None else None,
            "s_range": [h.s_begin, h.s_end] if h.s_begin is not None else None,
        }
        for i, h in enumerate(hits)
    ]
    return {"query": header, "hits": out, "cells": cells,
            "seconds": round(dt, 4)}


def cmd_search(args) -> int:
    from .util.profiling import trace

    ctx = _configure(args)
    ctx.init_db_fasta(args.db)
    if args.chunk_size:
        ctx.set_chunk_size(args.chunk_size)
    if getattr(args, "kernel", "auto") != "auto":
        ctx.params.kernel = args.kernel
    bw = {8: BitWidth.BIT8, 16: BitWidth.BIT16, 64: BitWidth.BIT64, 0: BitWidth.EXACT}[
        args.bit_width
    ]
    mode = ComputeMode.ALIGNMENT if args.align else ComputeMode.SCORE

    if args.all_queries:
        queries = ctx.init_sequences_fasta(args.query)
        atype = AlignType.SW if args.algo == "sw" else AlignType.NW
        t0 = time.perf_counter()
        with trace(getattr(args, "xprof", None)):
            lists = ctx.align_many(
                queries, k=args.k, mode=mode, align_type=atype, bit_width=bw
            )
        dt = time.perf_counter() - t0
        if args.json:
            # Stats are batch-level (one device sweep serves every query),
            # so cells/seconds are reported ONCE for the whole batch.
            print(json.dumps({
                "queries": [
                    {"query": q.header, "hits": _hit_json(hl, q.header, 0, 0)["hits"]}
                    for q, hl in zip(queries, lists)
                ],
                "cells": sum(
                    s.cells
                    for s in {id(hl.stats): hl.stats for hl in lists}.values()
                ),
                "seconds": round(dt, 4),
            }))
        else:
            print(f"{len(queries)} queries, {dt:.2f}s total")
            for q, hl in zip(queries, lists):
                print(f"query: {q.header}  ({len(hl)} hits)")
                for i, h in enumerate(hl):
                    _print_hit(h, i + 1, args.align)
        return 0

    query = ctx.init_sequence_fasta(args.query)
    fn = ctx.sw_align if args.algo == "sw" else ctx.nw_align
    t0 = time.perf_counter()
    with trace(getattr(args, "xprof", None)):
        hits = fn(query, k=args.k, bit_width=bw, mode=mode)
    dt = time.perf_counter() - t0
    if args.json:
        print(json.dumps(_hit_json(hits, query.header, hits.stats.cells, dt)))
    else:
        print(f"query: {query.header}  ({len(hits)} hits, "
              f"{hits.stats.cells/1e6:.1f} Mcells, {dt:.2f}s)")
        for i, h in enumerate(hits):
            _print_hit(h, i + 1, args.align)
    return 0


def cmd_pair(args) -> int:
    from .api import parse_sequence_arg

    ctx = _configure(args)
    query = ctx.init_sequence_fasta(args.query)
    # Strict resolution (api.parse_sequence_arg): a filename-looking
    # subject that does not exist raises instead of silently aligning
    # the letter-stripped path string.
    _, subject = parse_sequence_arg(args.subject, what="subject")
    a = ctx.align_pair(
        query, subject, AlignType.SW if args.algo == "sw" else AlignType.NW,
        mode=ComputeMode.SCORE if args.score_only else ComputeMode.ALIGNMENT,
    )
    _print_hit(a, 1, not args.score_only)
    return 0


def cmd_info(args) -> int:
    from .io.db import SequenceDB

    db = SequenceDB.from_fasta(args.db, _symtype(args.symtype))
    lengths = db.lengths
    print(json.dumps({
        "sequences": len(db),
        "residues": db.total_residues,
        "min_length": int(lengths.min()) if len(db) else 0,
        "max_length": int(lengths.max()) if len(db) else 0,
        "mean_length": float(lengths.mean()) if len(db) else 0.0,
    }))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="libssa_tpu", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("search", help="one query vs a FASTA database")
    ps.add_argument("--db", required=True)
    ps.add_argument("--query", required=True, help="FASTA file or bare sequence")
    ps.add_argument("-k", type=int, default=10, help="number of hits")
    ps.add_argument("--bit-width", type=int, choices=[0, 8, 16, 64], default=0,
                    help="precision-ladder start (0 = exact single pass)")
    ps.add_argument("--align", action="store_true", help="traceback alignments")
    ps.add_argument("--all-queries", action="store_true",
                    help="search every record of the query FASTA (batched)")
    ps.add_argument("--json", action="store_true")
    ps.add_argument("--chunk-size", type=int, default=None)
    ps.add_argument("--kernel", choices=["auto", "scan", "pallas"],
                    default="auto",
                    help="pin the scoring kernel (reference: pinning a SIMD level)")
    ps.add_argument("--xprof", metavar="DIR", default=None,
                    help="write a jax.profiler trace of the search to DIR")
    _add_scoring_args(ps)
    ps.set_defaults(fn=cmd_search)

    pp = sub.add_parser("pair", help="align one query against one subject")
    pp.add_argument("--query", required=True)
    pp.add_argument("--subject", required=True, help="FASTA file or bare sequence")
    pp.add_argument(
        "--score-only", action="store_true",
        help="score without traceback (kernel-rate path for huge pairs)",
    )
    _add_scoring_args(pp)
    pp.set_defaults(fn=cmd_pair)

    pi = sub.add_parser("info", help="packed-database statistics")
    pi.add_argument("--db", required=True)
    pi.add_argument("--symtype", choices=["aa", "nt"], default="aa")
    pi.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, RuntimeError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
