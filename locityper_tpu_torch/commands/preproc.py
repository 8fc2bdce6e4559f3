"""`preproc` command: estimate background distributions from a WGS sample.

Counterpart of reference command/preproc.rs: pick a background region, map
the sample's reads to it (internal banded aligner instead of
strobealign/minimap2 pipes, :716-988), then estimate insert-size, error and
depth models (:1076-1165).  Writes bg/distr.json.gz + success, in the same
format as the reference package's preproc.

Recruitment to the background region and the alignment of its reads run on
`args.device` (the CLI's `--device`, CUDA by default).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..bg import Technology
from ..pipeline import estimate_bg_from_reads
from ..seq import fastx, inputs
from ..seq.counts import GenomeKmerCounter
from ..utils import paths
from ..utils.io import Rerun, write_success
from ..utils.logging import get_logger

logger = get_logger("preproc")


def add_args(p):
    p.add_argument("-i", "--input", nargs="+", default=None,
                   help="Read files (1 = single/interleaved, 2 = paired)")
    p.add_argument("-a", "--alignments", nargs="+", default=None,
                   help="Coordinate-sorted indexed BAM/CRAM input(s): the "
                        "background region is fetched via the index "
                        "instead of scanning (preproc.rs -a; reads are "
                        "re-scored by the internal aligner)")
    p.add_argument("-I", "--in-list", default=None, metavar="FILE",
                   help="File listing input read files, one per line "
                        "(preproc.rs in_list)")
    p.add_argument("-r", "--reference", required=True, help="Reference FASTA")
    p.add_argument("-o", "--output", required=True, help="Output directory")
    p.add_argument("-b", "--bg-region", default=None,
                   help="Background region as chrom:start-end "
                        "(default: middle of the largest contig)")
    p.add_argument("--tech", default="illumina",
                   help="illumina/hifi/pacbio/ont [%(default)s]")
    p.add_argument("--interleaved", action="store_true")
    p.add_argument("-k", "--kmer", type=int, default=25)
    p.add_argument("--max-reads", type=int, default=200_000,
                   help="Cap on recruited reads used for estimation (the "
                        "whole input is always scanned; depth is corrected "
                        "for the subsampling)")
    p.add_argument("-p", "--ploidy", type=int, default=2,
                   help="Sample ploidy for haploid depth scaling "
                        "[%(default)s] (preproc.rs -p)")
    p.add_argument("-w", "--window", type=int, default=None,
                   help="Background window size (default: auto from read "
                        "length, bg/windows.rs:104-110)")
    p.add_argument("--boundary", type=int, default=1000,
                   help="Ignore windows within this distance of the "
                        "region boundary [%(default)s]")
    p.add_argument("--kmer-perc", type=float, default=90.0,
                   help="Minimal percentage of unique k-mers per window "
                        "[%(default)s]")
    p.add_argument("--frac-windows", type=float, default=0.5,
                   help="LOESS fraction of windows used per GC bin "
                        "[%(default)s]")
    p.add_argument("--blur-extreme", nargs=2, default=(100, 0.02),
                   metavar=("INT", "NUM"),
                   help="Blur depth at extreme GC: min window count + "
                        "variance multiplier [100 0.02] "
                        "(bg/depth.rs:98-126)")
    p.add_argument("--pval-thresh", nargs=2, type=float,
                   default=(0.001, 0.01), metavar=("NUM", "NUM"),
                   help="Insert-size and edit-distance p-value thresholds "
                        "for estimation filtering [0.001 0.01]")
    p.add_argument("-q", "--min-mapq", type=int, default=30,
                   help="Minimal mapping quality of alignments used for "
                        "estimation [%(default)s]")
    p.add_argument("-c", "--max-clip", type=float, default=0.02,
                   help="Ignore alignments clipped more than this "
                        "fraction of read length [%(default)s]")
    p.add_argument("--subsample", type=float, default=1.0,
                   help="Subsample input reads at this rate; depth "
                        "estimates are corrected [%(default)s]")
    p.add_argument("--seed", type=int, default=None,
                   help="Subsampling seed (reproducibility)")
    p.add_argument("--file-size", action="store_true",
                   help="With --like: rescale by file-size ratio even if "
                        "the donor sample stores a read count")
    p.add_argument("--skip-recruitment", action="store_true",
                   help="Use the first --max-reads input reads directly "
                        "instead of recruiting to the background region "
                        "(preproc.rs skip_recruitment; only correct when "
                        "the input is already region-restricted)")
    p.add_argument("--like", default=None, metavar="DIR",
                   help="Reuse another sample's distributions, rescaling "
                        "read depth by the read-count or file-size ratio "
                        "(preproc.rs:1304-1352)")
    p.add_argument("--rerun", default="none")
    p.add_argument("--debug", action="store_true",
                   help="Write depth estimation debug CSV (bg/depth.csv.gz)")
    p.add_argument("--describe", action="store_true",
                   help="Print the stored background distributions and exit")
    return p


def _input_size(paths) -> int:
    """Total input file size in bytes (preproc.rs sum_file_size)."""
    return sum(Path(p).stat().st_size for p in paths)


def _count_input(paths) -> tuple[int, int]:
    """(total_reads, total_file_size) of the input files — a full scan.
    Only used by --like (preproc.rs:1251-1263 counts the new sample on
    demand); regular preproc counts during the recruitment stream
    instead (single IO pass, preproc.rs:979)."""
    import gzip
    total_reads = 0
    total_size = 0
    for path in paths:
        total_size += Path(path).stat().st_size
        if str(path).endswith(".bam"):
            from ..seq import bam as bamio
            total_reads += sum(1 for _ in bamio.read_bam_records(path))
            continue
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rb") as f:
            first = f.readline()
            n_lines = 1 + sum(1 for _ in f)
        per_rec = 4 if first.startswith(b"@") else 2
        total_reads += n_lines // per_rec
    return total_reads, total_size


def run_like(args) -> int:
    """--like path: clone distributions, rescale depth (preproc.rs:1240-1352)."""
    from ..bg import BgDistr
    out = Path(args.output)
    bg_out = paths.bg_dir(out)
    rerun = Rerun.parse(args.rerun)
    if not rerun.prepare_dir(bg_out):
        logger.info("Preprocessing already done, skipping")
        return 0
    bg = BgDistr.load(paths.bg_dir(args.like) / paths.BG_DISTR)
    new_size = _input_size(args.input)
    new_reads = None
    if getattr(args, "file_size", False) and bg.seq_info.file_size:
        # --file-size: force the file-size ratio even when a read count
        # is stored (preproc.rs use_file_size, :585).
        rate = new_size / bg.seq_info.file_size
        how = f"file size ratio {new_size}/{bg.seq_info.file_size} (forced)"
    elif bg.seq_info.total_reads:
        # Counting requires a full scan — only do it when the donor sample
        # actually stored a count (preproc.rs:1246-1263).
        new_reads, _ = _count_input(args.input)
        if bg.insert_distr.is_paired_end:
            new_reads //= 2   # stored counts are read *pairs* when paired
        rate = new_reads / bg.seq_info.total_reads
        how = f"read count ratio {new_reads}/{bg.seq_info.total_reads}"
    elif bg.seq_info.file_size:
        rate = new_size / bg.seq_info.file_size
        how = f"file size ratio {new_size}/{bg.seq_info.file_size}"
    else:
        raise SystemExit("--like sample stores neither read count nor file size")
    logger.info("Rescaling depth by %.4f (%s)", rate, how)
    if bg.depth is not None:
        bg.depth.mul_depth(rate)
    bg.seq_info.total_reads = new_reads
    bg.seq_info.file_size = new_size
    bg.save(bg_out / paths.BG_DISTR)
    write_success(bg_out)
    return 0


# Default ~4.5 Mb duplication-free chr17 windows per genome build
# (preproc.rs:609-616).
_DEFAULT_BG = {"CHM13": ("chr17", 72_950_000, 77_450_000),
               "GRCh38": ("chr17", 72_062_000, 76_562_000),
               "GRCh37": ("chr17", 70_060_000, 74_560_000)}


def select_bg_region(genome: dict, spec: str | None, pad: int = 0):
    """(preproc.rs:610-657 + select_bg_interval): explicit -b region, else
    the build-specific chr17 default (build guessed from chr1 length,
    contigs.rs:244-255), else a central slice of the largest contig (sim
    genomes; the reference errors here instead)."""
    if spec:
        chrom, _, rng = spec.partition(":")
        start, _, end = rng.partition("-")
        return chrom, int(start.replace(",", "")), int(end.replace(",", ""))
    from ..seq.contigs import guess_genome_version
    ver = guess_genome_version(genome)
    if ver is not None:
        chrom, start, end = _DEFAULT_BG[ver]
        for name in (chrom, chrom[3:]):
            if name in genome and genome[name].size >= end:
                logger.info("Recognized %s reference genome, using background "
                            "region %s:%d-%d", ver, name, start + 1, end)
                return name, start, end
        raise ValueError(
            f"Recognized {ver} but it lacks a full {chrom}; provide -b "
            "explicitly (>3 Mb, without significant duplications)")
    name = max(genome, key=lambda n: genome[n].size)
    n = genome[name].size
    size = min(4_500_000, max(n // 2, min(n, 100_000)))
    start = (n - size) // 2
    logger.info("Unrecognized genome; using central %s:%d-%d as background",
                name, start + 1, start + size)
    return name, start, start + size


def describe(args) -> int:
    """preproc --describe (preproc.rs:1400-1409): re-print stored distrs."""
    import math

    from ..bg import BgDistr
    bg = BgDistr.load(paths.bg_dir(Path(args.output)) / paths.BG_DISTR)
    info = bg.seq_info
    print(f"technology: {info.technology.name.lower()}")
    print(f"mean read length: {info.read_len:.1f}")
    if info.total_reads:
        print(f"total reads: {info.total_reads}")
    if bg.insert_distr.is_paired_end:
        d = bg.insert_distr.distr
        print(f"insert size: {d.mean():.1f} +- {d.variance() ** 0.5:.1f}")
    ep = bg.err_prof
    print(f"error rates: mism {100 * math.exp(ep.ln_mismatch):.4f}%, "
          f"ins {100 * math.exp(ep.ln_insertion):.4f}%, "
          f"del {100 * math.exp(ep.ln_deletion):.4f}%")
    if bg.depth is not None:
        d = bg.depth.depth_distribution(40)
        print(f"read depth (GC 40, haploid): {d.mean():.2f} "
              f"+- {d.variance() ** 0.5:.2f} "
              f"(window {bg.depth.window_size})")
    return 0


def _input_is_paired(args) -> bool:
    if len(args.input) == 1 and str(args.input[0]).endswith(".bam"):
        from ..seq import bam as bamio
        return bamio.is_paired_bam(args.input[0])
    return len(args.input) == 2 or bool(args.interleaved)


def _load_head(args):
    """--skip-recruitment path: first --max-reads reads of the input."""
    reads1, reads2 = [], []
    for _name, c1, c2 in inputs.read_records(args.input, args.interleaved,
                                             reference=args.reference):
        reads1.append(c1)
        if c2 is not None:
            reads2.append(c2)
        if len(reads1) >= args.max_reads:
            break
    return reads1, reads2


# Background region padding for recruitment/mapping (preproc.rs:1377).
BG_PADDING = 50_000


def _recruit_bg_reads(args, genome, chrom, start, end, counter, tech,
                      device=None):
    """Streams the ENTIRE input, recruiting reads to the (padded)
    background region with the device recruitment kernel — the fix for
    round-1's first-200k-reads depth bias (preproc.rs:659-714 recruit-first
    + :1355-1397 BgRegion).  Returns (reads1, reads2, padded_region_seq,
    subsampling_rate, total_records) where rate < 1 when --max-reads
    capped the recruited set (depth estimation corrects for it,
    bg/depth.rs:268) and total_records counts the streamed input
    (read pairs for paired data) so no second IO pass is needed.
    device: None = CUDA (raises without one); "cpu" = plain PyTorch."""
    from types import SimpleNamespace

    from ..pipeline import recruit_reads_fast, recruit_records
    from ..seq.contigs import ContigSet
    from ..seq.counts import KmerCounts
    from ..seq.recruit import RecruitParams

    seq = genome[chrom]
    pad_lo = max(start - BG_PADDING, 0)
    pad_hi = min(end + BG_PADDING, seq.size)
    padded = seq[pad_lo:pad_hi]
    padded_counts = KmerCounts(counter.k, [counter.seq_counts(padded)])
    paired = _input_is_paired(args)
    params = RecruitParams(match_frac=tech.default_match_frac(paired))
    bg_target = SimpleNamespace(
        contig_set=ContigSet("bg", ["bg"], [padded]),
        kmer_counts=padded_counts)
    # Both paths count the streamed records (pairs) for
    # seq_info.total_reads, so no second IO pass is needed.
    fstats: dict = {}
    if inputs.takes_fastq_blocks(args.input, interleaved=args.interleaved,
                                 short_reads=tech.are_short_reads):
        # 2-FASTQ short reads: the native-parser block reader (no
        # per-read Python), the same engine the genotype command uses.
        out, speed = recruit_reads_fast({"bg": bg_target}, args.input[0],
                                        args.input[1], params, seed=0,
                                        stats=fstats, device=device)
    else:
        records = inputs.read_records(args.input, args.interleaved,
                                      reference=args.reference)
        out, speed = recruit_records({"bg": bg_target}, records, params,
                                     seed=0, stats=fstats, device=device)
    pairs, _names = out["bg"]
    logger.info("Recruited %d read%s to the background region (%.1fk reads/s)",
                len(pairs), " pairs" if paired else "s", speed / 1e3)
    if not pairs:
        raise ValueError("No reads recruited to the background region — "
                         "wrong reference or incompatible input?")
    rate = 1.0
    if len(pairs) > args.max_reads:
        rng = np.random.default_rng(0)
        sel = np.sort(rng.choice(len(pairs), args.max_reads, replace=False))
        rate = args.max_reads / len(pairs)
        pairs = [pairs[i] for i in sel]
        logger.info("Subsampled to %d reads for estimation (rate %.4f, "
                    "depth corrected)", len(pairs), rate)
    reads1 = [p[0] for p in pairs]
    reads2 = [p[1] for p in pairs] if (paired and pairs[0][1] is not None) \
        else []
    return reads1, reads2, padded, rate, fstats["records"]


def _fetch_bg_reads(args, genome, chrom, start, end):
    """Indexed-input path (preproc.rs:1180-1202): fetch the reads
    overlapping the padded background region directly instead of scanning
    the whole input — any mix of indexed BAM (.bai) / CRAM (.crai) files;
    no recruitment needed (the fetch IS region restriction).
    Returns (reads1, reads2, padded_region) or None when not applicable."""
    plans = inputs.indexed_plan(args.input or [], reference=args.reference)
    if not plans:
        return None
    seq = genome[chrom]
    pad_lo = max(start - BG_PADDING, 0)
    pad_hi = min(end + BG_PADDING, seq.size)
    per = {chrom: [(pad_lo, pad_hi)]}
    pairs, singles = [], []
    for kind, path in plans:
        # Region-only fetch (unplaced=False): unplaced tails are
        # irrelevant for bg depth — skip decoding them entirely.
        if kind == "bai":
            recs = inputs.bai_records(path, per, unplaced=False)
        else:
            recs = inputs.crai_records(path, per, args.reference,
                                       unplaced=False)
        # Mates pair within their own file (inputs.pair_fetched); orphans
        # whose mate fell outside the region pass as single reads.
        for _name, s1, s2 in inputs.pair_fetched(
                r for r in recs if r.pos >= 0):
            if s2 is None:
                singles.append(s1)
            else:
                pairs.append((s1, s2))
    # Estimation needs ONE consistent layout: majority wins.  reads1 and
    # reads2 must stay index-aligned (mate i of pair i), so singles never
    # interleave into a paired layout.
    if len(pairs) >= len(singles):
        reads1 = [p[0] for p in pairs]
        reads2 = [p[1] for p in pairs]
    else:
        reads1 = singles + [m for p in pairs for m in p]
        reads2 = []
    logger.info("Indexed input: fetched %d read(pair)s overlapping the "
                "background region from %d file(s) (no full scan)",
                len(reads1), len(plans))
    if not reads1:
        return None
    return reads1, reads2, seq[pad_lo:pad_hi]


def _assemble_inputs(args) -> None:
    """Merges -i / -a / -I into args.input (preproc.rs InputFiles):
    -a files are ordinary inputs here — when indexed, the fetch path
    picks them up; otherwise they stream like any BAM/CRAM."""
    inputs = list(args.input or [])
    inputs += list(getattr(args, "alignments", None) or [])
    if getattr(args, "in_list", None):
        listed = [l.strip() for l in open(args.in_list)
                  if l.strip() and not l.startswith("#")]
        if not listed:
            raise ValueError(f"{args.in_list}: no input files listed")
        inputs += listed
    if not inputs:
        raise ValueError("no input reads: provide -i/--input, "
                         "-a/--alignments or -I/--in-list")
    args.input = inputs


def run(args):
    from .._kernels import resolve_device
    if args.describe:
        return describe(args)
    _assemble_inputs(args)
    if args.like:
        return run_like(args)
    out = Path(args.output)
    bg_dir = paths.bg_dir(out)
    rerun = Rerun.parse(args.rerun)
    if not rerun.prepare_dir(bg_dir):
        logger.info("Preprocessing already done, skipping")
        return 0
    tech = Technology.parse(args.tech)
    device = resolve_device(getattr(args, "device", None))

    genome = dict(fastx.read_fasta(args.reference))
    chrom, start, end = select_bg_region(genome, args.bg_region)
    logger.info("Background region: %s:%d-%d", chrom, start, end)
    region = genome[chrom][start:end]
    counter = GenomeKmerCounter(args.kmer)
    for codes in genome.values():
        counter.add_seq(codes)
    counter.finalize()

    rate = 1.0
    # total_reads (pairs for paired data) is counted DURING the recruitment
    # stream — never by a second IO pass (preproc.rs:979 counts in the
    # mapping thread).  The indexed-fetch and --skip-recruitment paths
    # never scan the whole input, so only file size is stored there and
    # --like falls back to the file-size ratio (preproc.rs:1280-1300).
    total_records = None
    fetched = None if args.skip_recruitment else _fetch_bg_reads(
        args, genome, chrom, start, end)
    if args.skip_recruitment:
        reads1, reads2 = _load_head(args)
        logger.info("Loaded %d reads%s (recruitment skipped)", len(reads1),
                    " (paired)" if reads2 else "")
    elif fetched is not None:
        reads1, reads2, region = fetched
        if len(reads1) > args.max_reads:
            rng = np.random.default_rng(0)
            sel = np.sort(rng.choice(len(reads1), args.max_reads,
                                     replace=False))
            rate = args.max_reads / len(reads1)
            reads1 = [reads1[i] for i in sel]
            if reads2:
                reads2 = [reads2[i] for i in sel]
    else:
        reads1, reads2, region, rate, total_records = _recruit_bg_reads(
            args, genome, chrom, start, end, counter, tech, device=device)

    if args.subsample < 1.0:
        # Post-recruitment Bernoulli subsampling is statistically
        # identical to the reference's input-stream subsampling for
        # estimation (recruitment decisions are per-read); the rate
        # multiplies into the depth correction (preproc.rs:697-708).
        rng = np.random.default_rng(args.seed)
        keep = rng.random(len(reads1)) < args.subsample
        reads1 = [r for r, k in zip(reads1, keep) if k]
        if reads2:
            reads2 = [r for r, k in zip(reads2, keep) if k]
        rate *= args.subsample
        logger.info("Subsampled to %d reads (--subsample %.4g)",
                    len(reads1), args.subsample)

    from ..bg.depth import ReadDepthParams
    depth_params = ReadDepthParams(
        ploidy=args.ploidy, window_size=args.window,
        boundary_size=args.boundary, uniq_kmer_perc=args.kmer_perc,
        frac_windows=args.frac_windows,
        min_tail_obs=int(args.blur_extreme[0]),
        tail_var_mult=float(args.blur_extreme[1]))
    bg = estimate_bg_from_reads(reads1, reads2, region, counter, tech,
                              window_size=args.window,
                              depth_params=depth_params,
                              debug_dir=bg_dir if args.debug else None,
                              subsampling_rate=rate,
                              insert_pval=float(args.pval_thresh[0]),
                              edit_pval=float(args.pval_thresh[1]),
                              max_clipping=args.max_clip,
                              min_mapq=args.min_mapq, device=device)
    bg.seq_info.total_reads = total_records
    bg.seq_info.file_size = _input_size(args.input)
    bg.save(bg_dir / paths.BG_DISTR)
    write_success(bg_dir)
    bg_depth = bg.depth.depth_distribution(40)
    logger.info("Preprocessing done: read depth %.2f±%.2f (GC 40, haploid), "
                "insert %.0f, err mism %.4f%%",
                bg_depth.mean(), np.sqrt(bg_depth.variance()),
                bg.insert_distr.distr.mean() if bg.insert_distr.distr else 0,
                100 * np.exp(bg.err_prof.ln_mismatch))
    return 0
