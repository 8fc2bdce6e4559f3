"""`index` command: build a .bai / .crai for a coordinate-sorted BAM/CRAM.

The reference relies on pre-indexed inputs (samtools index); this owns the
writers (seq/bai.py, seq/crai.py) so indexed fetch-region recruitment
(genotype.rs:792-870) works without external tools.
"""
from __future__ import annotations

from ..utils.logging import get_logger

logger = get_logger("index")


def add_args(p):
    p.add_argument("input", help="Coordinate-sorted BAM or CRAM file")
    p.add_argument("-o", "--output", default=None,
                   help="Index path [<input>.bai / <input>.crai]")


def run(args):
    if str(args.input).endswith(".cram"):
        from ..seq.crai import build_crai
        out = args.output or (str(args.input) + ".crai")
        idx = build_crai(args.input, out)
        logger.info("Indexed %s: %d slice entries -> %s", args.input,
                    len(idx.entries), out)
        return 0
    from ..seq.bai import build_bai
    out = args.output or (str(args.input) + ".bai")
    idx = build_bai(args.input, out)
    n_placed = sum(len(chunks) for bins, _ in idx.refs
                   for chunks in bins.values())
    logger.info("Indexed %s: %d refs, %d chunk(s), %d unplaced reads -> %s",
                args.input, len(idx.refs), n_placed, idx.n_no_coor, out)
    return 0
