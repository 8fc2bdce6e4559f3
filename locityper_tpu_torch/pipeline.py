"""High-level per-locus genotyping pipeline: recruit → align → solve.

Counterpart of command/genotype.rs analyze_locus :1110-1207.  Every entry
point takes `device=None`, which means CUDA and raises when there is no CUDA
device; `device="cpu"` runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ._kernels import resolve_device
from .bg import BgDistr
from .bg.err_prof import EditDistCache, EditThresh
from .model import Params
from .model.assgn import LocusTensors
from .model.locs import build_all_alignments
from .model.windows import ContigInfoPack, NeighbProfile
from .seq.contigs import ContigSet, Genotype
from .seq.counts import KmerCounts
from .seq.recruit import RecruitParams, TargetIndex, recruit_any
from .solvers.solve import (Genotyping, PanelItem, Scheme, solve_locus,
                            solve_panel)
from .utils import spans
from .utils.logging import Progress, get_logger

logger = get_logger("pipeline")


@dataclass
class LocusData:
    contig_set: ContigSet
    kmer_counts: KmerCounts
    dist_matrix: np.ndarray | None = None


def _target_index(loci: dict, recruit_params: RecruitParams) -> TargetIndex:
    index = TargetIndex(recruit_params)
    for name in loci:
        index.add_locus(loci[name].contig_set, loci[name].kmer_counts)
    index.finalize()
    return index


def recruit_reads(loci: dict, read_iter, recruit_params: RecruitParams,
                  pad: int = 0):
    """Recruits all reads against all loci at once with the host engine
    (seq/recruit.py; genotype.rs:931-975), one read at a time: the oracle
    that the device recruiter (`recruit_reads_fast`, `recruit_records`) is
    tested against.

    loci: {name: LocusData}; read_iter yields (name, codes1, codes2 | None).
    pad: match every read with this many N codes appended, as a device
    batch sees a read that is shorter than its row (`minimizer_w - 1` or
    more saturates the effect); the reads are returned unpadded.
    Returns {locus: (read_pairs, names)} in `loci` order."""
    index = _target_index(loci, recruit_params)
    order = list(loci)
    out = {name: ([], []) for name in order}
    tail = np.full(pad, 4, np.int8)
    for name, c1, c2 in read_iter:
        m1 = np.concatenate([c1, tail]) if pad else c1
        m2 = np.concatenate([c2, tail]) if pad and c2 is not None else c2
        for locus_ix in recruit_any(index, m1, m2):
            pairs, names = out[order[locus_ix]]
            pairs.append((c1, c2))
            names.append(name)
    return out


#: The device takes pairs of mates up to SHORT_CAP bases, single reads up to
#: SHORT_CAP, and single reads up to LONG_CAP in long batches; the host
#: engine (`recruit_any`) the rest, one at a time.
SHORT_CAP = 500
LONG_CAP = 1 << 17
#: Items in flight: the upload of block N and the download of block N-2's
#: decisions overlap the device pass of block N-1.
PIPELINE_DEPTH = 3


@dataclass
class ReadBlock:
    """One device batch: the first `count` rows of `m1` (and of `m2`, mate
    2, in a batch of pairs) hold N-padded codes, `l1` (`l2`) their lengths
    and `names[i]` row i's name; `keep` marks the rows a subsample keeps;
    `long` takes single reads to the long-read decision (stretch rule)."""
    names: object               # list of str, or fastx.NameColumn
    m1: np.ndarray
    l1: np.ndarray
    count: int
    m2: np.ndarray | None = None
    l2: np.ndarray | None = None
    keep: np.ndarray | None = None
    long: bool = False


def _recruit_index(loci: dict, recruit_params: RecruitParams):
    from .ops.recruit import DeviceIndex
    with spans.span("recruit.index"):
        index = _target_index(loci, recruit_params)
        dev = DeviceIndex.from_index(index)
    logger.info("Recruitment index: %d minimizers over %d loci (device)",
                index.keys.size, index.n_loci)
    return index, dev


def _recruit_pass(loci: dict, index, dev, items, device, stats=None):
    """The one recruitment pass over `items` — ReadBlocks for the device,
    (name, codes1, codes2|None) records for the host engine.  A block is
    dispatched whole (pairs: to one device, or split over the local
    cards), up to PIPELINE_DEPTH items in flight while the host reads the
    next; results are taken in the items' order, so a read's place in each
    locus's list is that of its item.  Only rows with a hit cost Python
    work.  Returns ({locus: (read_pairs, names)}, reads/s); `stats` gains
    "records", the reads (pairs) counted."""
    import time

    from .ops.recruit import (run_long_async, run_pairs_async,
                              run_short_async, unpack_decisions)
    from .parallel.mesh import MeshPairRecruiter, resolve_mesh

    # Several cards: each block of pairs is split over the grid (linear
    # scaling, no collectives); one device keeps the plain asynchronous path.
    mesh = resolve_mesh("auto", device)
    if mesh is not None:
        dispatch_pairs = MeshPairRecruiter(mesh, dev).run_async
        logger.info("Recruitment sharded over %d devices", mesh.devices.size)
    else:
        def dispatch_pairs(m1, m2):
            return run_pairs_async(dev, m1, m2, device=device)
    params = index.params

    def dispatch(b: ReadBlock):
        if b.m2 is not None:
            return dispatch_pairs(b.m1[:b.count], b.m2[:b.count])
        if b.long:
            return run_long_async(dev, b.m1[:b.count], params.stretch_minims,
                                  params.stretch_score, device=device)
        return run_short_async(dev, b.m1[:b.count], device=device)

    order = list(loci)
    out = {name: ([], []) for name in order}
    progress = Progress(logger, "reads")

    def scatter(item, res):
        if res is None:                     # a record for the host engine
            name, c1, c2 = item
            with spans.span("recruit.decide"):
                hit = recruit_any(index, c1, c2)
            with spans.span("recruit.scatter"):
                for lx in hit:
                    out[order[lx]][0].append((c1, c2))
                    out[order[lx]][1].append(name)
                progress.add(1, int(bool(hit)))
            return
        b = item
        # Packed [B, G] uint32 bitmaps: only rows with ANY hit are unpacked
        # (the test runs on the packed words), and only their reads are
        # copied out of the block.
        with spans.span("recruit.decide"):
            packed = res.numpy()[:b.count]
        with spans.span("recruit.scatter"):
            live = packed.any(axis=1)
            if b.keep is not None:
                live &= b.keep
            rows = np.nonzero(live)[0]
            if rows.size:
                ri, li = np.nonzero(unpack_decisions(packed[rows],
                                                     len(order)))
                m2 = b.m2
                reads = {int(i): (b.m1[i, :b.l1[i]].copy(),
                                  None if m2 is None
                                  else m2[i, :b.l2[i]].copy())
                         for i in rows}
                for i, lx in zip(rows[ri], li):
                    out[order[lx]][0].append(reads[int(i)])
                    out[order[lx]][1].append(b.names[i])
            progress.add(b.count, int(rows.size))

    pending = []                # [(item, pending decisions | None)]
    first = None    # dispatch time of the first block; 0 once it is back

    def take():
        nonlocal first
        item, res = pending.pop(0)
        scatter(item, res)
        if first and res is not None:
            # The first block's decisions: the time before them is the
            # kernels' build (first use in a fresh checkout) and the first
            # roundtrip.  With more to come, the clock restarts for the
            # steady-state speed (a one- or two-block input keeps it).
            dt, first = time.perf_counter() - first, 0.0
            if dt > 5.0:
                logger.info("Recruitment kernel ready in %.0f s (build; "
                            "cached for subsequent runs)", dt)
            if pending:
                progress.reset_clock()

    while True:
        with spans.span("recruit.parse"):
            item = next(items, None)
        if item is None:
            break
        res = None
        if isinstance(item, ReadBlock):
            with spans.span("recruit.dispatch"):
                if first is None:
                    first = time.perf_counter()
                res = dispatch(item)
        pending.append((item, res))
        while len(pending) > PIPELINE_DEPTH:
            take()
    while pending:
        take()
    speed = progress.final()
    spans.count("pairs_parsed", progress.processed)
    spans.count("pairs_recruited", progress.recruited)
    if stats is not None:
        stats["records"] = progress.processed
    return out, speed


def _fill(seqs, L: int):
    """[len(seqs), L] N-padded codes and int32 lengths of a sequence list,
    in one masked assignment."""
    lens = np.fromiter((c.size for c in seqs), np.int32, len(seqs))
    m = np.full((len(seqs), L), 4, np.int8)
    m[np.arange(L)[None, :] < lens[:, None]] = np.concatenate(seqs)
    return m, lens


def _record_blocks(records, batch: int, subsample, seed: int):
    """Groups (name, codes1, codes2|None) records into ReadBlocks by kind,
    in record order within each: pairs, short single reads, and long single
    reads by power-of-two length class.  A block goes out when full (long:
    2^21 codes, at least 8 reads), the rest at the end (pairs, short reads,
    the long classes by length); a record that no kernel takes goes out as
    it is.  `subsample` draws one number a record, in record order.

    The widths are the reference package's — short rows a multiple of 64
    codes, long rows their class — because the width is part of the
    function: a row pads its read with N, and a minimizer window at a
    read's end may run into the padding.  With the reference's widths both
    packages decide alike on every read."""
    rng = np.random.default_rng(seed)

    def block(buf, L=None, long=False):
        if L is None:
            L = max(max(c1.size, 0 if c2 is None else c2.size)
                    for _, c1, c2 in buf)
            L = -(-L // 64) * 64
        m1, l1 = _fill([c1 for _, c1, _ in buf], L)
        m2, l2 = (None, None) if buf[0][2] is None \
            else _fill([c2 for _, _, c2 in buf], L)
        return ReadBlock([rec[0] for rec in buf], m1, l1, len(buf), m2, l2,
                         long=long)

    pairs, shorts, longs = [], [], {}   # longs: length class -> records
    for rec in records:
        name, c1, c2 = rec
        if subsample is not None and rng.random() >= subsample:
            continue
        if c2 is None and c1.size > SHORT_CAP:
            if c1.size > LONG_CAP:
                yield rec
                continue
            L = 1024
            while L < c1.size:
                L *= 2
            longs.setdefault(L, []).append(rec)
            if len(longs[L]) >= max((1 << 21) // L, 8):
                yield block(longs.pop(L), L, long=True)
        elif c2 is None:
            shorts.append(rec)
            if len(shorts) >= batch:
                yield block(shorts)
                shorts = []
        elif c1.size <= SHORT_CAP and c2.size <= SHORT_CAP:
            pairs.append(rec)
            if len(pairs) >= batch:
                yield block(pairs)
                pairs = []
        else:
            yield rec
    yield from (block(buf) for buf in (pairs, shorts) if buf)
    yield from (block(longs[L], L, long=True) for L in sorted(longs))


def recruit_records(loci: dict, records, recruit_params: RecruitParams,
                    subsample=None, seed=0, batch=16384,
                    stats: dict | None = None, device=None):
    """Recruits the reads of any source — (name, codes1, codes2|None)
    records, e.g. seq/inputs.py:open_records — against all loci at once
    (genotype.rs:931-975): pairs of mates up to 500 bases and single reads
    up to 131,072 bases on the device, in blocks (`_record_blocks`;
    bit-identical to the host engine on the padded read), the rest on the
    host engine.  Returns ({locus: (read_pairs, names)}, reads/s); `stats`
    gains "records", the records streamed after `subsample`.
    device: None = CUDA (raises without one); "cpu" = plain PyTorch."""
    device = resolve_device(device)
    index, dev = _recruit_index(loci, recruit_params)
    return _recruit_pass(loci, index, dev,
                         _record_blocks(records, batch, subsample, seed),
                         device, stats)


def recruit_reads_fast(loci: dict, path1, path2,
                       recruit_params: RecruitParams, subsample=None, seed=0,
                       batch=32768, max_len=None, stats: dict | None = None,
                       device=None):
    """Recruits the pairs of two FASTQ files against all loci at once, in
    blocks from the native parser (seq/fastx.py:fast_paired_batches): no
    per-read Python from bytes to per-locus read lists.  Returns ({locus:
    (read_pairs, names)}, reads/s); `stats` gains "records", the pairs
    streamed (preproc's seq_info.total_reads, with no second IO pass).
    `subsample` draws one number a pair, a block at a time.

    max_len=None sizes the block width from the files' leading records
    (64-bucketed); a longer read appearing mid-stream restarts the pass at
    the wider bucket — reads are NEVER clipped (the reference recruiter
    always sees full sequences, recruit.rs:852-932).
    device: None = CUDA (raises without one); "cpu" = plain PyTorch."""
    from .seq.fastx import (MaxLenExceeded, _bucket_len, fast_paired_batches,
                            probe_fastq_max_len)
    from .utils.io import Prefetch

    device = resolve_device(device)
    index, dev = _recruit_index(loci, recruit_params)
    if max_len is None:
        with spans.span("recruit.parse"):
            max_len = _bucket_len(probe_fastq_max_len((path1, path2)))
    while True:
        rng = np.random.default_rng(seed)
        try:
            # The mates are inflated and parsed on a thread each and paired
            # into blocks on a third (zlib and the parser release the GIL):
            # block N+1 is read while this thread scatters N-1 and feeds
            # the device with N.  Leaving the `with` stops and joins all
            # three.
            with Prefetch(fast_paired_batches(
                    path1, path2, batch=batch, max_len=max_len,
                    span_parent=spans.current()), depth=2) as parsed:
                blocks = (ReadBlock(names, m1, l1, n, m2, l2,
                                    keep=None if subsample is None
                                    else rng.random(n) < subsample)
                          for names, m1, l1, m2, l2, n in parsed)
                return _recruit_pass(loci, index, dev, blocks, device, stats)
        except MaxLenExceeded as exc:
            new_len = _bucket_len(exc.max_seen)
            logger.warning(
                "Read of %d bp exceeds the %d bp batch width; restarting "
                "recruitment at width %d (no reads are ever clipped)",
                exc.max_seen, max_len, new_len)
            max_len = new_len


def genotype_locus(locus: LocusData, read_pairs, names, bg: BgDistr,
                   params: Params | None = None, scheme: Scheme | None = None,
                   seed: int = 1, ploidy: int = 2, tag: str | None = None,
                   priors: dict | None = None, explicit_weights=None,
                   sam_dir=None, sol_path=None, debug: int = 0,
                   out_dir=None, prebuilt_alns=None, mesh="auto",
                   device=None) -> tuple[Genotyping, dict]:
    """Genotypes one locus from recruited reads.

    read_pairs: list of (codes1, codes2 | None).
    Returns (Genotyping, stats).

    prebuilt_alns: optional (AllAlignments, stats) from
    model/locs.py:build_all_alignments_panel — multi-locus batched
    alignment (the per-locus align step is then skipped).
    device: None = CUDA (raises without one); "cpu" = plain PyTorch.
    mesh: "auto" (default) splits alignment and solving over all local
    cards when more than one is attached (parallel/mesh.py:auto_mesh); a
    parallel/mesh.py Mesh; None forces the one device.
    """
    from .parallel.mesh import resolve_mesh
    device = resolve_device(device)
    mesh = resolve_mesh(mesh, device)
    params = params or Params()
    tag = tag or locus.contig_set.tag
    window_size = bg.depth.window_size
    neighb_size = bg.depth.neighb_size
    params.set_tweak_size(window_size)

    tech = bg.seq_info.technology
    if params.band is None:
        params.band = 48 if tech.are_short_reads else 160
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    profile = NeighbProfile(locus.contig_set, locus.kmer_counts, neighb_size,
                            params)
    if prebuilt_alns is not None:
        all_alns, stats = prebuilt_alns
    else:
        with spans.span("align"):
            all_alns, stats = build_all_alignments(
                read_pairs, names, locus.contig_set, locus.kmer_counts, bg,
                edit_cache, params, explicit_weights=explicit_weights,
                device=device, mesh=mesh, profile=profile)
    logger.info("    [%s] %d/%d reads usable (%d poorly mapped, %d out of "
                "bounds, %d low weight)", tag, all_alns.n_used,
                stats["total"], stats["poorly_mapped"], stats["out_of_bounds"],
                stats["few_kmers"])
    if not all_alns.n_used:
        return Genotyping(tag=tag, genotypes=[], ln_probs=np.empty(0),
                          predictions=[], quality=0.0, total_reads=0,
                          warnings=["NoReads"]), stats

    with spans.span("solve"):
        prep = _prepare_solve_inputs(locus, all_alns, bg, params, ploidy,
                                     priors, explicit_weights, debug, out_dir,
                                     profile=profile)
        scheme = scheme or Scheme.default()
        sol_writer = None
        gt_names = None
        if sol_path is not None:
            from .utils.io import smart_create
            sol_writer = smart_create(sol_path)
            sol_writer.write("stage\tgenotype\tscore\n")
            gt_names = prep["gt_names"]
        try:
            result = solve_locus(prep["tensors"], prep["pack"], bg,
                                 prep["genotypes"], prep["priors"], params,
                                 scheme, seed, tag=tag,
                                 dist_matrix=prep["dist_matrix"],
                                 sol_writer=sol_writer, gt_names=gt_names,
                                 mesh=mesh, device=device)
        finally:
            if sol_writer is not None:
                sol_writer.close()
        _finalize_locus(result, locus, all_alns, prep["tensors"], bg, params,
                        ploidy, read_pairs, sam_dir)
    return result, stats


def _prepare_solve_inputs(locus: LocusData, all_alns, bg: BgDistr,
                          params: Params, ploidy: int, priors,
                          explicit_weights, debug: int, out_dir,
                          profile: NeighbProfile | None = None) -> dict:
    """Shared pre-solve assembly: window infos, packed tensors, genotype
    enumeration, prior vector (genotype.rs analyze_locus :1110-1150).
    `profile`: the locus's NeighbProfile of this call, when post-alignment
    has one (None: built here)."""
    if profile is None:
        profile = NeighbProfile(locus.contig_set, locus.kmer_counts,
                                bg.depth.neighb_size, params)
    infos = profile.contig_infos(bg.depth.window_size, explicit_weights)
    if debug >= 1 and out_dir is not None:
        _write_windows_bed(out_dir, locus.contig_set, infos)
    if debug >= 2 and out_dir is not None:
        _write_read_pairs_csv(out_dir, locus.contig_set, all_alns)
    pack = ContigInfoPack.pack(infos)
    tensors = LocusTensors.build(all_alns)
    n_haps = len(locus.contig_set.seqs)
    hnames = locus.contig_set.contigs.names
    dist_matrix = locus.dist_matrix
    # Any ploidy runs natively: genotypes are [G, P] and the solver's
    # candidate/window tensors scale as K = P·Kh + 1, W = 2 + P·max_windows
    # (genotype.rs:1077-1108, ext/vec.rs:293-339).
    if priors:
        # The priors file DEFINES the genotype list (genotype.rs:1077-1101):
        # only listed genotypes with a finite prior are evaluated.
        entries = [(ids, lp) for ids, lp in sorted(priors.items())
                   if np.isfinite(lp) and len(ids) == ploidy]
        if not entries:
            raise ValueError("No usable genotypes in the priors file "
                             f"(ploidy {ploidy})")
        genotypes = np.array([ids for ids, _ in entries], np.int32)
        prior_vec = np.array([lp for _, lp in entries])
        gt_names = [",".join(hnames[h] for h in ids) for ids, _ in entries]
    else:
        gts = Genotype.generate_all(n_haps, ploidy)
        genotypes = np.array([g.ids for g in gts], np.int32)
        prior_vec = np.zeros(len(gts))
        gt_names = [",".join(hnames[h] for h in g.ids) for g in gts]
    return dict(tensors=tensors, pack=pack, genotypes=genotypes,
                priors=prior_vec, gt_names=gt_names,
                dist_matrix=dist_matrix)


def _finalize_locus(result, locus: LocusData, all_alns, tensors, bg: BgDistr,
                    params: Params, ploidy: int, read_pairs,
                    sam_dir) -> None:
    """Shared post-solve steps: unexplained-read count and warnings
    (solve.rs:636-716), and the SAM/BAM files of the best genotypes
    (`--out-sams`, `--out-bams`; model/sam.py)."""
    if not result.genotypes:
        return
    # Unexplained reads (solve.rs:706-716), over all P haps of the call.
    best_gt = result.genotypes[0]
    n_real = tensors.n_reads
    best_per_read = np.max(
        [tensors.hap_prob[h, :n_real].max(axis=1) for h in best_gt], axis=0)
    unm = (tensors.unmapped_prob if tensors.unmapped_prob.ndim == 1
           else tensors.unmapped_prob[best_gt[0]])
    result.unexpl_reads = int(np.sum(best_per_read < unm[:n_real] + 1e-8))
    if result.ln_probs.size and (np.isnan(result.ln_probs[0])
                                 or result.ln_probs[0] < -2.0 * np.log(10.0)):
        result.warnings.append("NoProbableGenotype")
    # Read-count sanity (check_num_of_reads, solve.rs:636-665).
    n_reads = all_alns.n_used
    if n_reads < ploidy:
        result.warnings.append(f"FewReads({n_reads})")
    elif ploidy > 1 and n_reads < ploidy * 10:
        k, n = float(ploidy), float(n_reads)
        exp_zeros = np.exp(np.log(k - 1.0) * n - np.log(k) * (n - 1.0))
        if exp_zeros > 0.1:
            result.warnings.append(f"FewReads({n_reads})")

    n_out = max(params.out_bams, params.out_sams)
    if sam_dir is not None and n_out > 0:
        from .model.sam import write_sam
        from pathlib import Path
        Path(sam_dir).mkdir(parents=True, exist_ok=True)
        hap_names = locus.contig_set.contigs.names
        hap_lens = [s.size for s in locus.contig_set.seqs]
        read_names = all_alns.names_used
        weights = all_alns.weights_used
        score_vec = bg.err_prof.score_vec()
        for i, (gt, pred) in enumerate(zip(result.genotypes,
                                           result.predictions)):
            if i >= n_out or pred.assignments is None:
                break
            paths = ([Path(sam_dir) / f"{i:02d}.bam"]
                     if i < params.out_bams else [])
            if i < params.out_sams:
                paths.append(Path(sam_dir) / f"{i:02d}.sam.gz")
            write_sam(paths, tuple(gt), tensors,
                      hap_names, hap_lens, read_names,
                      pred.assignments[:, :len(read_names)],
                      read_weights=weights, all_alns=all_alns,
                      read_pairs=read_pairs,
                      hap_seqs=locus.contig_set.seqs, score_vec=score_vec,
                      band=params.band)


def genotype_panel(entries: list, bg: BgDistr, params: Params | None = None,
                   scheme: Scheme | None = None, seed: int = 1,
                   ploidy: int = 2, mesh="auto", device=None) -> list:
    """Genotypes a PANEL of loci with solver stages batched across loci
    (solvers/solve.py:solve_panel — chains from every locus share the
    annealer calls, so small per-locus genotype counts still fill the
    device).

    entries: list of dicts with keys
        locus (LocusData), read_pairs, names, tag, prebuilt (AllAlignments,
        stats), and optionally priors, explicit_weights, sam_dir, sol_path,
        debug, out_dir, profile (the locus's NeighbProfile of the call,
        shared with the alignment that made `prebuilt`).
    device: None = CUDA (raises without one); "cpu" = plain PyTorch.
    mesh: as in `genotype_locus`.
    Returns list of (Genotyping, stats) in entry order.  Calls match
    per-locus `genotype_locus`.
    """
    from .parallel.mesh import resolve_mesh
    device = resolve_device(device)
    mesh = resolve_mesh(mesh, device)
    params = params or Params()
    scheme = scheme or Scheme.default()
    tech = bg.seq_info.technology
    params.set_tweak_size(bg.depth.window_size)
    if params.band is None:
        params.band = 48 if tech.are_short_reads else 160

    results: list = [None] * len(entries)
    items, preps, live = [], [], []
    writers = []
    with spans.span("solve.prep"):
        for ei, e in enumerate(entries):
            locus = e["locus"]
            tag = e.get("tag") or locus.contig_set.tag
            all_alns, stats = e["prebuilt"]
            logger.info("    [%s] %d/%d reads usable (%d poorly mapped, %d "
                        "out of bounds, %d low weight)", tag, all_alns.n_used,
                        stats["total"], stats["poorly_mapped"],
                        stats["out_of_bounds"], stats["few_kmers"])
            if not all_alns.n_used:
                results[ei] = (Genotyping(
                    tag=tag, genotypes=[], ln_probs=np.empty(0),
                    predictions=[], quality=0.0, total_reads=0,
                    warnings=["NoReads"]), stats)
                continue
            prep = _prepare_solve_inputs(
                locus, all_alns, bg, params, ploidy, e.get("priors"),
                e.get("explicit_weights"), e.get("debug", 0), e.get("out_dir"),
                profile=e.get("profile"))
            sol_writer = None
            if e.get("sol_path") is not None:
                from .utils.io import smart_create
                sol_writer = smart_create(e["sol_path"])
                sol_writer.write("stage\tgenotype\tscore\n")
                writers.append(sol_writer)
            items.append(PanelItem(
                tensors=prep["tensors"], pack=prep["pack"],
                genotypes=prep["genotypes"], priors=prep["priors"], tag=tag,
                dist_matrix=prep["dist_matrix"], sol_writer=sol_writer,
                gt_names=prep["gt_names"]))
            preps.append(prep)
            live.append(ei)

    if items:
        try:
            solved = solve_panel(items, bg, params, scheme, seed,
                                 mesh=mesh, device=device)
        finally:
            for w in writers:
                w.close()
        with spans.span("solve.final"):
            for item_ix, ei in enumerate(live):
                e = entries[ei]
                result = solved[item_ix]
                all_alns, stats = e["prebuilt"]
                _finalize_locus(result, e["locus"], all_alns,
                                preps[item_ix]["tensors"], bg, params, ploidy,
                                e["read_pairs"], e.get("sam_dir"))
                results[ei] = (result, stats)
    return results


def _write_windows_bed(out_dir, contig_set, infos) -> None:
    """windows.bed.gz: per-haplotype genotyping windows with GC and weight
    (reference genotype.rs:1132-1136 windows_writer)."""
    from pathlib import Path

    from .utils.io import smart_create
    with smart_create(Path(out_dir) / "windows.bed.gz") as f:
        f.write("#contig\tstart\tend\tgc\tweight\n")
        for name, info in zip(contig_set.contigs.names, infos):
            for ws in info.default_window_starts():
                ws = int(ws)
                f.write(f"{name}\t{ws}\t{ws + info.window_size}\t"
                        f"{int(info.gc_at[ws])}\t"
                        f"{float(info.weight_at[ws]):.5f}\n")


def _write_read_pairs_csv(out_dir, contig_set, all_alns) -> None:
    """read_pairs.csv.gz: every candidate location of every modeled read
    (reference genotype.rs:1162-1166 write_read_pair_info)."""
    from pathlib import Path

    from .utils.io import smart_create
    names = contig_set.contigs.names
    with smart_create(Path(out_dir) / "read_pairs.csv.gz") as f:
        f.write("read\tweight\tunmapped_prob\tcontig\tln_prob\t"
                "middle1\tmiddle2\n")
        for ra in all_alns.reads:
            for c in ra.cands:
                f.write(f"{ra.name}\t{ra.weight:.4f}\t"
                        f"{ra.unmapped_prob:.3f}\t{names[c.hap]}\t"
                        f"{c.ln_prob:.3f}\t{c.middle1}\t{c.middle2}\n")


def estimate_bg_from_reads(reads1, reads2, region_seq, region_counter,
                         technology, window_size=None,
                         depth_params=None, seed=0,
                         debug_dir=None, subsampling_rate: float = 1.0,
                         insert_pval: float = 0.001,
                         edit_pval: float = 0.01,
                         max_clipping: float = 0.02,
                         min_mapq: int = 0, device=None) -> BgDistr:
    """Estimates all background distributions by aligning reads to a single
    background region (counterpart of preproc estimate_bg_distrs,
    command/preproc.rs:1076-1165).

    Filtering parity with the reference:
    - alignments clipped more than `max_clipping`·len are dropped
      (preproc.rs:268-269, 303);
    - `min_mapq` drops ambiguous placements; with the internal aligner
      MAPQ is derived from the best-vs-second-best ln-prob gap
      (~4.343·Δln, the usual Phred mapping) — the reference gets the
      equivalent number from strobealign/minimap2 (preproc.rs:547);
    - the error profile uses only pairs whose insert size lies in the
      (1-insert_pval) confidence interval (preproc.rs:1087-1102);
    - depth counting uses only reads whose edit distance passes the
      (1-edit_pval) BetaBinomial quantile (preproc.rs:1106-1122).

    The mates are aligned by `model/locs.py:_align_candidates` at band 48
    in batches of 2,048 jobs.  device: None = CUDA (raises without one);
    "cpu" = the plain PyTorch version of the aligner."""
    from .bg import SequencingInfo
    from .bg.depth import ReadDepth, ReadDepthParams, auto_window_size
    from .bg.insertsz import InsertDistr
    from .bg.err_prof import ErrorProfile
    from .bg.windows import BgWindows
    from .model.locs import HapMinimizerIndex, _align_candidates
    from .ops import align as A
    from .seq.contigs import ContigSet

    device = resolve_device(device)
    depth_params = depth_params or ReadDepthParams()
    mean_len = float(np.mean([r.size for r in reads1])) if reads1 else 150.0
    wsize, neighb = auto_window_size(mean_len) if window_size is None \
        else (window_size, max(window_size, 300))
    seq_info = SequencingInfo(mean_len, technology, total_reads=len(reads1))

    cset = ContigSet("bg", ["bg"], [region_seq])
    hap_index = HapMinimizerIndex(cset, 15, 10)
    # Preliminary error scores (refined after alignment).
    prelim = A.Scores.from_error_rates(0.005, 0.001, 0.001)
    score_vec = np.array(prelim.astuple(), np.float32)

    mates, mate_read, mate_end = [], [], []
    for i, r1 in enumerate(reads1):
        mates.append(r1)
        mate_read.append(i)
        mate_end.append(0)
        if reads2:
            mates.append(reads2[i])
            mate_read.append(i)
            mate_end.append(1)
    jobs = hap_index.candidates_batch_flat(mates, 10, 48, 2, 2)
    aln_lists = _align_candidates(mates, jobs, cset, score_vec, 48,
                                  device=device).to_lists(len(mates))

    # Pick the best alignment per mate; drop over-clipped or ambiguous
    # placements (preproc.rs max_clipping / min_mapq — see docstring).
    rlens = np.array([m.size for m in mates])
    best = []
    for a, L in zip(aln_lists, rlens):
        if not a:
            best.append(None)
            continue
        srt = sorted(a, key=lambda x: x.ln_prob, reverse=True)
        b = srt[0]
        if b.n_clip > max_clipping * int(L):
            best.append(None)
            continue
        if min_mapq > 0 and len(srt) > 1:
            mapq = 4.342945 * (srt[0].ln_prob - srt[1].ln_prob)
            if mapq < min_mapq:
                best.append(None)
                continue
        best.append(b)
    ends_ix = list(mate_end)

    # Insert sizes from best mate alignments (estimated FIRST: the error
    # profile is restricted to pairs inside the insert confidence
    # interval, preproc.rs:1085-1102).
    insert_distr = InsertDistr.undefined()
    insert_ok = [True] * len(reads1)
    if reads2:
        sizes = []
        same_o = opp_o = 0
        for i in range(len(reads1)):
            b1, b2 = best[2 * i], best[2 * i + 1]
            if b1 is None or b2 is None:
                continue
            sizes.append(max(b1.end, b2.end) - min(b1.start, b2.start))
            if b1.fwd == b2.fwd:
                same_o += 1
            else:
                opp_o += 1
        insert_distr = InsertDistr.estimate(np.array(sizes), same_o, opp_o)
        lo, hi = insert_distr.confidence_interval(1.0 - insert_pval)
        for i in range(len(reads1)):
            b1, b2 = best[2 * i], best[2 * i + 1]
            if b1 is None or b2 is None:
                continue
            ins = max(b1.end, b2.end) - min(b1.start, b2.start)
            insert_ok[i] = lo <= ins <= hi

    def _mate_ok(j):
        return insert_ok[mate_read[j]] if reads2 else True

    # Error profile from exact op counts of the best alignments
    # (bg/err_prof.rs:152-199), insert-filtered when paired.
    n_match = n_mism = n_ins = n_del = 0
    triples = {}
    for j, (b, L) in enumerate(zip(best, rlens)):
        if b is None or not _mate_ok(j):
            continue
        matches = int(L) - b.n_mism - b.n_ins - b.n_clip
        n_match += matches
        n_mism += b.n_mism
        n_ins += b.n_ins
        n_del += b.n_del
        key = (b.edit, int(L))
        triples[key] = triples.get(key, 0) + 1
    err_prof = ErrorProfile.estimate(
        max(n_match, 1), max(n_mism, 1), max(n_ins, 1), max(n_del, 1),
        [(e, n, float(c)) for (e, n), c in triples.items()])

    # Depth counting below uses only reads whose edit distance passes the
    # (1-edit_pval) quantile for their length (SingleEditDistCache,
    # err_prof.rs:333-361); for pairs BOTH mates must pass
    # (preproc.rs:1110-1122).
    _edit_cache: dict = {}

    def _edit_ok(j):
        b = best[j]
        if b is None:
            return False
        L = int(rlens[j])
        t = _edit_cache.get(L)
        if t is None:
            t = err_prof.edit_distr.inv_cdf(L, 1.0 - edit_pval)
            _edit_cache[L] = t
        return b.edit <= t

    depth_ok = []
    for j in range(len(mates)):
        if reads2:
            i = mate_read[j]
            depth_ok.append(_mate_ok(j) and _edit_ok(2 * i)
                            and _edit_ok(2 * i + 1))
        else:
            depth_ok.append(_edit_ok(j))

    # Window depth.
    win = BgWindows.create(region_seq, 0, region_counter.seq_counts(region_seq),
                           region_counter.k, wsize, neighb,
                           depth_params.boundary_size,
                           0.01 * depth_params.uniq_kmer_perc)
    middles = []
    for j, (b, me) in enumerate(zip(best, ends_ix)):
        if b is not None and me == 0 and depth_ok[j]:
            middles.append((b.start + b.end) // 2)
    middles = np.array(middles, np.int64)
    w = (middles - win.region_start) // wsize
    ok = (middles >= win.region_start) & (w >= 0) & (w < len(win))
    depth_counts = np.zeros(len(win), np.int64)
    np.add.at(depth_counts, w[ok], 1)
    keep = win.keep
    if debug_dir is not None:
        # depth.csv.gz: per-window depth counts with GC and keep flag
        # (reference bg/depth.rs:204-238 debug writer).
        from pathlib import Path

        from .utils.io import smart_create
        Path(debug_dir).mkdir(parents=True, exist_ok=True)
        with smart_create(Path(debug_dir) / "depth.csv.gz") as f:
            f.write("window\tstart\tgc\tcount\tkeep\n")
            for i in range(len(win)):
                f.write(f"{i}\t{win.region_start + i * wsize}\t"
                        f"{int(win.gc[i])}\t{int(depth_counts[i])}\t"
                        f"{int(win.keep[i])}\n")
    depth = ReadDepth.estimate(depth_counts[keep], win.gc[keep], wsize, neighb,
                               depth_params,
                               subsampling_rate=subsampling_rate,
                               has_gc_bias=technology.has_gc_bias)
    return BgDistr(seq_info, insert_distr, err_prof, depth)
