"""`genotype` command: the main per-sample analysis.

Counterpart of reference command/genotype.rs (run :1209-1309,
analyze_locus :1110-1207): load background distributions + DB loci, recruit
reads against all loci at once, then per locus run the recruit→align→solve
pipeline and write res.json.gz.

Recruitment, alignment and solving run on `args.device` (the CLI's
`--device`, CUDA by default); a failure of any of them raises.  With more
than one local card they are split over all of them
(parallel/mesh.py:auto_mesh); with several processes (`torchrun`) the loci
are split across processes (parallel/multihost.py).
"""
from __future__ import annotations

import contextlib
import gzip
import json
from pathlib import Path

import numpy as np

from ..bg import BgDistr
from ..model import Params
from ..model.windows import NeighbProfile
from ..pipeline import (LocusData, genotype_locus, recruit_reads_fast,
                        recruit_records)
from ..seq import fastx, inputs
from ..seq.contigs import ContigSet
from ..seq.counts import KmerCounts
from ..seq.recruit import RecruitParams
from ..solvers.solve import Scheme
from ..utils import paths, spans
from ..utils.io import Rerun, write_success
from ..utils.logging import get_logger

logger = get_logger("genotype")

#: Per-locus recruited-read checkpoint (reference genotype.rs:662-682 writes
#: reads.fq.gz after recruitment and deletes it once the locus completes,
#: :1153-1156 — a crash between recruit and solve resumes without
#: re-scanning the whole input).
RECRUITED_FQ = "reads.fq.gz"


def _save_recruited(ldir: Path, pairs, names) -> None:
    """Checkpoints recruited reads as <locus>/reads.fq.gz."""
    from ..seq.fastx import Read, write_fastq
    from ..utils.io import smart_create
    ldir.mkdir(parents=True, exist_ok=True)
    with smart_create(ldir / RECRUITED_FQ) as f:
        for (c1, c2), nm in zip(pairs, names):
            write_fastq(f, Read(nm + "/1", c1))
            if c2 is not None:
                write_fastq(f, Read(nm + "/2", c2))


def _load_recruited(ldir: Path):
    """Loads a reads.fq.gz checkpoint back into (pairs, names).

    Inverse of `_save_recruited`: "/1"+"/2" record pairs become mate pairs,
    lone "/1" records become single reads.
    """
    from ..seq.fastx import read_fastq
    pairs: list = []
    names: list = []
    pending = None
    for r in read_fastq(ldir / RECRUITED_FQ):
        stem, sep, end = r.name.rpartition("/")
        if sep and end == "2" and pending == stem:
            pairs[-1] = (pairs[-1][0], r.seq)
            pending = None
            continue
        pairs.append((r.seq, None))
        names.append(stem if sep and end in ("1", "2") else r.name)
        pending = stem if (sep and end == "1") else None
    return pairs, names


def add_args(p):
    p.add_argument("-i", "--input", nargs="+", default=None)
    p.add_argument("-d", "--db", required=True, help="Database directory")
    p.add_argument("-p", "--preproc", required=True,
                   help="Preprocessing output directory")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--loci", nargs="*", default=None,
                   help="Subset of loci to genotype (default: all)")
    p.add_argument("--interleaved", action="store_true")
    p.add_argument("-S", "--solvers", nargs="*", default=None,
                   help='Solver stages, e.g. "greedy:i=5k,a=1" "anneal:i=20,a=20"; '
                        'engine e=auto (= chains, pallas: the parallel-chains '
                        'annealer) or e=seq (the sequential engine, the '
                        'reference greedy)')
    p.add_argument("-P", "--ploidy", type=int, default=2)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--subsample", type=float, default=None,
                   help="Recruit this fraction of reads")
    p.add_argument("--stop-after", choices=("recruit", "map", "all"),
                   default="all",
                   help="Stop after a pipeline stage (genotype.rs:52-69): "
                        "'recruit' writes recruited reads and exits")
    p.add_argument("--debug", type=int, nargs="?", const=1, default=0,
                   help="Debug CSV level (command/mod.rs DebugLvl): 1 = "
                        "sol.csv.gz + windows.bed.gz, 2 = + read_pairs"
                        ".csv.gz")
    p.add_argument("--out-sams", type=int, default=0,
                   help="Write read assignments for this many best genotypes "
                        "as SAM.gz files under <locus>/alns/")
    p.add_argument("--out-bams", type=int, default=0,
                   help="Same as --out-sams but real BGZF BAM files "
                        "(the reference's model/bam.rs output format)")
    p.add_argument("--reg-weights", default=None, metavar="TSV",
                   help="Per-locus explicit region weights: each line "
                        "'<locus> <bed-path>'; the BED has "
                        "'<hap> <start> <end> <weight in [0,1]>' rows "
                        "(genotype.rs load_explicit_weights, "
                        "model/windows.rs ExplicitWeights)")
    p.add_argument("--priors", default=None, metavar="TSV",
                   help="Genotype priors file: '<locus> <hapA,hapB> <log10 prior>' "
                        "(non-positive; genotype.rs:563-619)")
    p.add_argument("--rerun", default="none")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a torch.profiler trace of the run into DIR "
                        "as a Chrome trace (chrome://tracing / Perfetto; "
                        "SURVEY.md §5.1)")
    p.add_argument("-I", "--in-list", default=None, metavar="FILE",
                   help="File listing input read files, one per line "
                        "(genotype.rs -I)")
    p.add_argument("-r", "--reference", default=None, metavar="FASTA",
                   help="Reference FASTA: required for reference-based CRAM "
                        "input, enables indexed fetch-region recruitment "
                        "for coordinate-sorted BAM/CRAM (fastx.rs:586-887)")
    p.add_argument("--leave-out", nargs="*", default=None, metavar="HAP",
                   help="Exclude these haplotypes from every locus panel "
                        "(genotype.rs --leave-out)")
    # Recruitment knobs (recruit.rs Params).
    p.add_argument("-m", "--minimizer", default=None, metavar="K,W",
                   help="Minimizer k,w [15,10]")
    p.add_argument("-M", "--match-frac", type=float, default=None,
                   help="Minimizer match fraction (default per technology)")
    p.add_argument("-L", "--match-len", type=int, default=2000,
                   help="Long-read match length [%(default)s]")
    p.add_argument("--kmer-thresh", type=int, default=10,
                   help="Rare k-mer count threshold [%(default)s]")
    # Model knobs (model/mod.rs Params).
    p.add_argument("--skew", type=float, default=None,
                   help="Likelihood skew: depth weight 1+skew, aln 1-skew "
                        "[0.85]")
    p.add_argument("-D", "--prob-diff", type=float, default=None,
                   help="Candidate location prob. difference, log10 [2]")
    p.add_argument("-U", "--unmapped", type=float, default=None,
                   help="Unmapped-read penalty, log10 (default per tech)")
    p.add_argument("-A", "--alt-cn", type=float, nargs="*", default=None,
                   help="Alternative copy numbers [0.3 2 3 4 5]")
    p.add_argument("--complexity", type=int, default=None,
                   help="Linguistic complexity k-mer size [5]")
    p.add_argument("--kmers-weight", default=None, metavar="B,P",
                   help="Unique-kmer weight sigmoid breakpoint,power [0.2,4]")
    p.add_argument("--compl-weight", default=None, metavar="B,P",
                   help="Complexity weight sigmoid breakpoint,power [0.5,4]")
    p.add_argument("--min-weight", type=float, default=None,
                   help="Minimum read weight to include in the model [0.001]")
    p.add_argument("--read-kmers", default=None, metavar="HARD,SOFT",
                   help="Unique-kmer read thresholds hard,soft [1,5]")
    p.add_argument("-t", "--tweak", type=int, default=None,
                   help="Window tweak size (default auto: min(w/2, 200))")
    p.add_argument("--filt-diff", type=float, default=None,
                   help="Stage-filter score difference, log10 [100]")
    p.add_argument("--prob-thresh", type=float, default=None,
                   help="Genotype probability threshold, log10 [-4]")
    p.add_argument("--dont-skip", action="store_true",
                   help="Never skip genotypes in solver stages")
    return p


def _apply_param_args(params, args):
    """Maps CLI tuning flags onto model Params (genotype.rs:447-505)."""
    import numpy as np
    LN10 = float(np.log(10.0))
    if args.skew is not None:
        params.lik_skew = args.skew
    if args.prob_diff is not None:
        params.prob_diff = args.prob_diff * LN10
    if args.unmapped is not None:
        params.unmapped_penalty = args.unmapped * LN10
    if args.alt_cn:
        params.alt_cn = tuple(args.alt_cn)
    if args.complexity is not None:
        params.complexity_k = args.complexity
    if args.kmers_weight:
        b, p_ = args.kmers_weight.split(",")
        params.kmers_weight_breakpoint = float(b)
        params.kmers_weight_power = float(p_)
    if args.compl_weight:
        b, p_ = args.compl_weight.split(",")
        params.compl_weight_breakpoint = float(b)
        params.compl_weight_power = float(p_)
    if args.min_weight is not None:
        params.min_weight = args.min_weight
    if args.read_kmers:
        h, soft = args.read_kmers.split(",")
        params.kmer_hard_thresh = int(h)
        params.kmer_soft_thresh = int(soft)
    if args.tweak is not None:
        params.tweak = args.tweak
    if args.filt_diff is not None:
        params.filt_diff = args.filt_diff * LN10
    if args.prob_thresh is not None:
        params.prob_thresh = args.prob_thresh * LN10
    if args.dont_skip:
        params.dont_skip = True
    return params


def load_priors(path) -> dict:
    """{locus: {\"hapA,hapB\": ln prior}}."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            fields = line.split()
            if not fields or fields[0].startswith("#"):
                continue
            locus, gt, p = fields[0], fields[1], float(fields[2])
            if p > 0 or np.isnan(p):
                raise SystemExit(f"Invalid prior {p} for genotype {gt}")
            out.setdefault(locus, {})[gt] = p * np.log(10.0)
    return out


def load_locus(db: Path, name: str) -> LocusData:
    ldir = paths.locus_dir(db, name)
    named = [(r.name, r.seq) for r in fastx.read_fastx_auto(ldir / paths.HAPLOTYPES)]
    cset = ContigSet(name, [n for n, _ in named], [s for _, s in named])
    kc = KmerCounts.load_npz(ldir / paths.KMER_COUNTS)
    dist = None
    dist_path = ldir / paths.DISTANCES
    if dist_path.exists():
        dist = np.load(dist_path)["div"]
    return LocusData(cset, kc, dist)


def _params_snapshot(args) -> dict:
    """The analysis parameters that make old outputs incompatible (the
    reference's MappingParams staleness check, preproc.rs:792-879)."""
    keys = ("db", "preproc", "ploidy", "minimizer", "match_frac", "match_len",
            "kmer_thresh", "skew", "prob_diff", "unmapped", "alt_cn",
            "complexity", "kmers_weight", "compl_weight", "min_weight",
            "read_kmers", "tweak", "filt_diff", "prob_thresh", "dont_skip",
            "leave_out", "solvers", "subsample")
    return {k: getattr(args, k, None) for k in keys}


def _check_params_staleness(args, out: Path, rerun: Rerun) -> None:
    """Compares this run's parameters with the ones stored in the output
    directory; mismatches abort with guidance unless --rerun all (which
    starts clean).  Mirrors preproc.rs:792-879."""
    import json as _json
    snap_path = out / "params.json"
    snap = _params_snapshot(args)
    if rerun is Rerun.ALL or not snap_path.exists():
        out.mkdir(parents=True, exist_ok=True)
        with open(snap_path, "w") as f:
            _json.dump(snap, f, indent=1, default=str)
        return
    stored = _json.loads(snap_path.read_text())
    cur = _json.loads(_json.dumps(snap, default=str))
    diffs = [k for k in cur if stored.get(k) != cur.get(k)]
    if diffs:
        raise ValueError(
            f"{out} was produced with different parameters "
            f"({', '.join(diffs)} changed). Rerun with --rerun all to "
            "recompute from scratch, or restore the original parameters")


def _leave_out(data: LocusData, names: set, tag: str) -> LocusData:
    """Drops panel haplotypes by name (genotype.rs --leave-out)."""
    keep = [i for i, n in enumerate(data.contig_set.contigs.names)
            if n not in names]
    if len(keep) == len(data.contig_set.contigs.names):
        return data
    if len(keep) < 2:
        raise ValueError(f"[{tag}] --leave-out removes all haplotypes")
    cs = ContigSet(data.contig_set.tag,
                   [data.contig_set.contigs.names[i] for i in keep],
                   [data.contig_set.seqs[i] for i in keep])
    kc = KmerCounts(data.kmer_counts.k,
                    [data.kmer_counts.counts[i] for i in keep])
    dist = None
    if data.dist_matrix is not None:
        dist = data.dist_matrix[np.ix_(keep, keep)]
    logger.info("[%s] left out %d haplotype(s), %d remain", tag,
                len(data.contig_set.seqs) - len(keep), len(keep))
    return LocusData(cs, kc, dist)


def _locus_cost_estimate(db: Path, name: str) -> float:
    """Cheap per-locus cost proxy for multi-host LPT sharding: genotype
    count (~H^2/2 at diploid) x mean haplotype length, read from the
    haplotype FASTA headers/line lengths without building the locus.
    Falls back to 1.0 (uniform) when unreadable."""
    fa = Path(db) / paths.LOCI_DIR / name / paths.HAPLOTYPES
    try:
        n_haps, total = 0, 0
        with gzip.open(fa, "rt") as f:
            for line in f:
                if line.startswith(">"):
                    n_haps += 1
                else:
                    total += len(line) - 1
        if n_haps == 0:
            return 1.0
        return (n_haps * (n_haps + 1) / 2.0) * (total / n_haps)
    except OSError:
        return 1.0


def list_loci(db: Path) -> list[str]:
    loci_dir = Path(db) / paths.LOCI_DIR
    return sorted(d.name for d in loci_dir.iterdir()
                  if (d / paths.HAPLOTYPES).exists())


def _load_ref_intervals(db: Path, names):
    """Reference intervals of the loci (db/<locus>/ref.bed, written by
    `add`); None when any locus lacks one (fall back to full scan)."""
    out = []
    for name in names:
        p = paths.locus_dir(db, name) / paths.REF_BED
        if not p.exists():
            return None
        fields = p.read_text().split()
        out.append((fields[0], int(fields[1]), int(fields[2])))
    return out


#: Counter of the call -> kernel of `_kernels.LAUNCHES` whose launches it
#: takes.
LAUNCH_COUNTERS = {"k1_launches": "align_banded",
                   "k2_launches": "anneal_chains",
                   "k3_launches": "minimizer_front_compact"}


def run(args):
    """One `genotype` call inside the span recorder's call (utils/spans.py),
    whose close logs the call's seconds by layer and step and its counters;
    with `--profile`, under `torch.profiler`, each span annotating the
    trace."""
    from .. import _kernels
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if getattr(args, "device", "cuda") != "cpu":
            activities.append(ProfilerActivity.CUDA)
        prof_dir = Path(args.profile)
        prof_dir.mkdir(parents=True, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
    try:
        with spans.call("genotype", annotate=prof is not None) as call:
            launches0 = dict(_kernels.LAUNCHES)
            try:
                return _run(args)
            finally:
                for counter, kernel in LAUNCH_COUNTERS.items():
                    spans.count(counter, _kernels.LAUNCHES[kernel]
                                - launches0[kernel])
    finally:
        logger.info("%s", spans.summary(call))
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(str(prof_dir / "trace.json"))
            logger.info("Profiler trace written to %s",
                        prof_dir / "trace.json")


def _run(args):
    with spans.span("entry.load"):
        from .._kernels import resolve_device
        device = resolve_device(getattr(args, "device", None))
        if args.in_list:
            listed = [l.strip() for l in open(args.in_list)
                      if l.strip() and not l.startswith("#")]
            if not listed:
                raise ValueError(f"{args.in_list}: no input files listed")
            args.input = (args.input or []) + listed
        if not args.input:
            raise ValueError(
                "no input reads: provide -i/--input or -I/--in-list")
        db = Path(args.db)
        out = Path(args.output)
        rerun = Rerun.parse(args.rerun)
        bg = BgDistr.load(paths.bg_dir(args.preproc) / paths.BG_DISTR)
        tech = bg.seq_info.technology
        _check_params_staleness(args, out, rerun)

        # Multi-host: loci split across processes (no collective on any
        # tensor; parallel/multihost.py); cards within a host split each
        # batch over the grid.  Cost-weighted LPT partition: per-locus wall
        # time is dominated by genotype count x haplotype length (align +
        # solve legs), so a panel mixing 6-hap and 300-hap loci leaves no
        # round-robin stragglers (genotype.rs:1278-1298 outer loop).
        from ..parallel.multihost import maybe_init_distributed, shard_loci
        multi = maybe_init_distributed()
        all_names = args.loci if args.loci else list_loci(db)
        costs = ([_locus_cost_estimate(db, n) for n in all_names] if multi
                 else None)
        locus_names = shard_loci(all_names, costs)
        loci = {}
        todo = []
        for name in locus_names:
            ldir = out / paths.LOCI_DIR / name
            if not rerun.prepare_dir(ldir, keep=(RECRUITED_FQ,)):
                logger.info("[%s] already genotyped, skipping", name)
                continue
            data = load_locus(db, name)
            if args.leave_out:
                data = _leave_out(data, set(args.leave_out), name)
            loci[name] = data
            todo.append(name)
        if not todo:
            logger.info("Nothing to do")
            return 0

        mk, mw = (15, 10)
        if args.minimizer:
            mk, mw = (int(x) for x in args.minimizer.split(","))
        rp = RecruitParams(
            minimizer_k=mk, minimizer_w=mw,
            match_frac=(
                args.match_frac if args.match_frac is not None else
                tech.default_match_frac(bg.insert_distr.is_paired_end)),
            match_length=args.match_len, thresh_kmer_count=args.kmer_thresh)
        # Resume from per-locus checkpoints where a previous (crashed) run
        # already recruited (genotype.rs:662-682).
        recruited = {}
        need = {}
        for name in todo:
            ldir = out / paths.LOCI_DIR / name
            if (ldir / RECRUITED_FQ).exists():
                recruited[name] = _load_recruited(ldir)
                logger.info("[%s] reusing %d recruited read(pair)s from "
                            "checkpoint %s", name, len(recruited[name][0]),
                            ldir / RECRUITED_FQ)
            else:
                need[name] = loci[name]
    if need:
        with spans.span("recruit"):
            if inputs.takes_fastq_blocks(args.input,
                                         interleaved=args.interleaved,
                                         short_reads=tech.are_short_reads):
                rec, _ = recruit_reads_fast(
                    need, args.input[0], args.input[1], rp,
                    subsample=args.subsample, seed=args.seed, device=device)
            else:
                records = inputs.open_records(
                    args.input, args.interleaved,
                    reference=getattr(args, "reference", None),
                    regions=_load_ref_intervals(db, list(need)))
                with contextlib.closing(records):
                    rec, _ = recruit_records(need, records, rp,
                                             subsample=args.subsample,
                                             seed=args.seed, device=device)
        recruited.update(rec)
        with spans.span("entry.write"):
            for name in need:
                _save_recruited(out / paths.LOCI_DIR / name,
                                *recruited[name])

    if args.stop_after == "recruit":
        for name in todo:
            logger.info("[%s] wrote %d recruited read(pair)s", name,
                        len(recruited[name][0]))
        return 0

    if args.stop_after == "map":
        from ..bg.err_prof import EditDistCache, EditThresh
        from ..model.locs import build_all_alignments
        from ..model.sam import write_all_sam
        params = Params(unmapped_penalty=tech.default_unmapped_penalty())
        if params.band is None:
            params.band = 48 if tech.are_short_reads else 160
        edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
        for name in todo:
            pairs, names_ = recruited[name]
            cs = loci[name].contig_set
            all_alns, _ = build_all_alignments(
                pairs, names_, cs, loci[name].kmer_counts, bg, edit_cache,
                params, device=device)
            ldir = out / paths.LOCI_DIR / name
            ldir.mkdir(parents=True, exist_ok=True)
            # aln.bam (reference genotype.rs:1023-1074 writes BAM) plus
            # the readable SAM.gz twin — one record pass feeds both sinks
            # (the host traceback CIGAR regeneration runs once).
            write_all_sam([ldir / "aln.bam", ldir / "aln.sam.gz"], all_alns,
                          pairs, cs.contigs.names,
                          [sq.size for sq in cs.seqs], cs.seqs,
                          bg.err_prof.score_vec(), params.band)
            logger.info("[%s] wrote %d modeled reads' alignments to "
                        "aln.bam/aln.sam.gz (%d recruited)", name,
                        all_alns.n_used, len(pairs))
        return 0

    scheme = Scheme.parse(args.solvers or [])
    params = Params(unmapped_penalty=tech.default_unmapped_penalty(),
                    out_bams=args.out_bams, out_sams=args.out_sams)
    _apply_param_args(params, args)
    all_priors = load_priors(args.priors) if args.priors else {}
    weight_files = {}
    if args.reg_weights:
        from pathlib import Path as _P
        base = _P(args.reg_weights).parent
        for line in open(args.reg_weights):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split()
            if len(cols) != 2:
                raise ValueError(f"{args.reg_weights}: expected "
                                 f"'<locus> <file>' lines, got {line!r}")
            path = _P(cols[1])
            if not path.is_absolute():
                path = base / path
            if not path.exists():
                raise ValueError(f"{args.reg_weights}: {path} does not exist")
            weight_files[cols[0]] = path
    # Each locus's neighbourhood profile, built on first use and read by
    # both post-alignment and the solver's inputs: once a call.
    profiles = {name: NeighbProfile(loci[name].contig_set,
                                    loci[name].kmer_counts,
                                    bg.depth.neighb_size, params)
                for name in todo}
    # Multi-locus device batching: align every locus's candidate jobs in
    # one global device stream (model/locs.py:build_all_alignments_panel);
    # per-locus results are identical to the unbatched path.  A failure
    # here raises: nothing falls back to the per-locus loop.
    panel_alns = {}
    if len(todo) > 1:
        from ..bg.err_prof import EditDistCache, EditThresh
        from ..model.locs import build_all_alignments_panel
        from ..parallel.mesh import resolve_mesh
        params.set_tweak_size(bg.depth.window_size)
        if params.band is None:
            params.band = 48 if tech.are_short_reads else 160
        edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))

        def _panel_explicit(n):
            if n not in weight_files:
                return None
            from ..model.windows import ExplicitWeights
            return ExplicitWeights.load(weight_files[n])

        panel = [(recruited[n][0], recruited[n][1], loci[n].contig_set,
                  loci[n].kmer_counts, _panel_explicit(n)) for n in todo]
        with spans.span("align"):
            built = build_all_alignments_panel(
                panel, bg, edit_cache, params, device=device,
                mesh=resolve_mesh("auto", device),
                profiles=[profiles[n] for n in todo])
        panel_alns = dict(zip(todo, built))
        logger.info("Aligned %d loci in one device stream (%d reads)",
                    len(todo), sum(s["total"] for _, s in built))

    def _locus_extras(name):
        explicit = None
        if name in weight_files:
            from ..model.windows import ExplicitWeights
            explicit = ExplicitWeights.load(weight_files[name])
        locus_priors = None
        if name in all_priors:
            cn = loci[name].contig_set.contigs
            locus_priors = {}
            for gt_str, lp in all_priors[name].items():
                ids = tuple(sorted(cn.id_of(h) for h in gt_str.split(",")))
                locus_priors[ids] = lp
        return explicit, locus_priors

    # Cross-locus batched solving: every stage runs one device program for
    # the whole panel (solvers/solve.py:solve_panel — the annealer is
    # latency-bound at per-locus genotype counts).  A failure raises.
    panel_results = {}
    if len(todo) > 1:
        from ..pipeline import genotype_panel
        entries = []
        for name in todo:
            pairs, names = recruited[name]
            ldir = out / paths.LOCI_DIR / name
            logger.info("[%s] %d recruited read(pair)s", name, len(pairs))
            explicit, locus_priors = _locus_extras(name)
            entries.append(dict(
                locus=loci[name], read_pairs=pairs, names=names, tag=name,
                prebuilt=panel_alns[name], priors=locus_priors,
                explicit_weights=explicit, profile=profiles[name],
                sam_dir=(ldir / paths.ALNS_OUT_DIR)
                if (args.out_sams or args.out_bams) else None,
                sol_path=(ldir / paths.SOL_CSV) if args.debug else None,
                debug=args.debug, out_dir=ldir))
        with spans.span("solve"):
            solved = genotype_panel(entries, bg, params=params, scheme=scheme,
                                    seed=args.seed, ploidy=args.ploidy,
                                    device=device)
        panel_results = dict(zip(todo, solved))

    failures = 0
    for li, name in enumerate(todo):
        pairs, names = recruited[name]
        ldir = out / paths.LOCI_DIR / name
        if name in panel_results:
            result, stats = panel_results[name]
        else:
            logger.info("[%s] %d recruited read(pair)s", name, len(pairs))
            explicit, locus_priors = _locus_extras(name)
            try:
                result, stats = genotype_locus(
                    loci[name], pairs, names, bg, params=params,
                    scheme=scheme, seed=args.seed + li, tag=name,
                    ploidy=args.ploidy, priors=locus_priors,
                    explicit_weights=explicit,
                    sam_dir=(ldir / paths.ALNS_OUT_DIR)
                    if (args.out_sams or args.out_bams) else None,
                    sol_path=(ldir / paths.SOL_CSV) if args.debug else None,
                    debug=args.debug, out_dir=ldir, device=device)
            except Exception:
                logger.exception("[%s] genotyping failed", name)
                failures += 1
                continue
        with spans.span("entry.write"):
            with gzip.open(ldir / paths.RES_JSON, "wt") as f:
                json.dump(result.to_json(loci[name].contig_set.contigs.names),
                          f, indent=1)
            write_success(ldir)
            # Locus done — drop its recruited-read checkpoint
            # (genotype.rs:1153-1156).
            (ldir / RECRUITED_FQ).unlink(missing_ok=True)
        if result.genotypes:
            logger.info("[%s] GT = %s, quality %.1f", name,
                        result.to_json(loci[name].contig_set.contigs.names)
                        .get("genotype"), result.quality)
    return 1 if failures else 0
