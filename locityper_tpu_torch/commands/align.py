"""`align` command: pairwise haplotype alignment producing PAF.

Counterpart of reference command/align.rs + seq/dist.rs.  Per pair: exact
backbone k-mer matches (k in {25,51,101}) are chained with LCSk++ and the
inter-anchor gaps filled with affine-gap DP (dist.rs:115-271,
wfa.rs:259-304 smart_align), best-of-k by score; output is a full-length
PAF row with NM/AS/dv/qv/um/md/cg tags (dist.rs:273-321).  The hot path
(fingerprints, match join, chain + gap fill) is native
(native/kernels.cpp); pairs are spread over a thread pool (the ctypes
calls release the GIL), the counterpart of dist.rs:349-389's per-thread
pair ranges.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from itertools import combinations

from ..seq import fastx
from ..seq.dist import (
    BACKBONE_KS, DIV_K, DIV_W, MAX_GAP, THRESH_DIV, PairAligner, Penalties,
    minimizer_divergence, paf_row,
)
from ..utils.io import smart_create
from ..utils.logging import get_logger

logger = get_logger("align")


def add_args(p):
    p.add_argument("-i", "--input", required=True, help="Haplotype FASTA")
    p.add_argument("-o", "--output", required=True, help="Output PAF(.gz)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("-A", "--all", "--all-pairs", dest="all_pairs",
                   action="store_true", help="Align all pairs")
    g.add_argument("-p", "--pairs", nargs="+", default=None,
                   help="name,name pairs to align")
    g.add_argument("-P", "--pairs-file", default=None,
                   help="Two-column file of pairs")
    g.add_argument("--against", default=None,
                   help="Align every sequence against this one")
    p.add_argument("-m", "--minimizer", nargs=2, type=int,
                   default=[DIV_K, DIV_W], metavar=("K", "W"),
                   help="Minimizers for the divergence gate")
    p.add_argument("-s", "--skip-div", action="store_true",
                   help="Skip divergence calculation")
    p.add_argument("-D", "--thresh-div", "--max-div", dest="thresh_div",
                   type=float, default=THRESH_DIV,
                   help="Skip alignment above this minimizer divergence")
    p.add_argument("-k", "--backbone", default=",".join(map(str, BACKBONE_KS)),
                   help="Comma-separated backbone k-mer sizes")
    p.add_argument("-g", "--max-gap", type=int, default=MAX_GAP,
                   help="Do not fully align gaps over this size")
    p.add_argument("-M", "--mismatch", type=int, default=4)
    p.add_argument("-O", "--gap-open", type=int, default=6)
    p.add_argument("-E", "--gap-extend", type=int, default=1)
    p.add_argument("-@", "--threads", type=int, default=8)
    p.add_argument("--ignore-missing", action="store_true",
                   help="Silently skip pairs with unknown names")
    return p


def select_pairs(args, names):
    """Pair selection per align.rs:58-66, 263-270: exactly one of
    -A / -p / -P / --against (default -A)."""
    name2id = {n: i for i, n in enumerate(names)}

    def lookup(n):
        i = name2id.get(n)
        if i is None and not args.ignore_missing:
            raise SystemExit(f"align: unknown sequence name `{n}`")
        return i

    if args.pairs:
        out = []
        for s in args.pairs:
            a, _, b = s.partition(",")
            i, j = lookup(a), lookup(b)
            if i is not None and j is not None:
                out.append((i, j))
        return out
    if args.pairs_file:
        out = []
        with open(args.pairs_file) as f:
            for line in f:
                fields = line.split()
                if len(fields) < 2:
                    continue
                i, j = lookup(fields[0]), lookup(fields[1])
                if i is not None and j is not None:
                    out.append((i, j))
        return out
    if args.against:
        tgt = name2id.get(args.against)
        if tgt is None:
            raise SystemExit(f"align: unknown sequence `{args.against}`")
        return [(tgt, j) for j in range(len(names)) if j != tgt]
    return list(combinations(range(len(names)), 2))


def run(args):
    named = [(r.name, r.seq) for r in fastx.read_fastx_auto(args.input)]
    names = [n for n, _ in named]
    pairs = select_pairs(args, names)
    ks = tuple(int(k) for k in str(args.backbone).split(","))
    pen = Penalties(args.mismatch, args.gap_open, args.gap_extend)
    aligner = PairAligner(ks=ks, max_gap=args.max_gap, penalties=pen)
    logger.info("Aligning %d pairs of %d haplotypes (backbone k=%s)",
                len(pairs), len(named), args.backbone)

    in_use = sorted({i for ij in pairs for i in ij})
    fps = {}
    if aligner.native:
        for i in in_use:
            fps[i] = aligner.fingerprints(named[i][1])
    k, w = args.minimizer

    def process(ij):
        i, j = ij
        div = None
        if not args.skip_div:
            div = minimizer_divergence(named[i][1], named[j][1], k, w)
            if div[1] > args.thresh_div:
                return paf_row(names[i], named[i][1], names[j], named[j][1],
                               aln=None, div=div)
        aln = aligner.align(named[i][1], named[j][1], fps.get(i), fps.get(j))
        return paf_row(names[i], named[i][1], names[j], named[j][1],
                       aln=aln, div=div)

    n_rows = 0
    with smart_create(args.output) as f:
        if args.threads > 1 and len(pairs) > 1:
            with ThreadPoolExecutor(max_workers=args.threads) as ex:
                for row in ex.map(process, pairs):
                    f.write(row + "\n")
                    n_rows += 1
        else:
            for ij in pairs:
                f.write(process(ij) + "\n")
                n_rows += 1
    logger.info("Wrote %d PAF rows to %s", n_rows, args.output)
    return 0
