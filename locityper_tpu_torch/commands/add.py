"""`add` command: build per-locus database entries.

Counterpart of reference command/add.rs: per locus — haplotype sequences
(FASTA per locus, or extracted from a pangenome VCF in later rounds),
genome-wide k-mer counting (jellyfish replaced by seq/counts.py), off-target
counts, discarding identical haplotypes (:505-541), minimizer divergence
matrix (:544-608), on-disk layout per utils/paths.py.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..seq import fastx
from ..seq.counts import GenomeKmerCounter, off_target_counts
from ..seq.kmers import sorted_minimizer_set, jaccard_distance
from ..utils import paths
from ..utils.io import Rerun, smart_create, write_success
from ..utils.logging import get_logger

logger = get_logger("add")


def add_args(p):
    p.add_argument("-d", "--db", required=True, help="Output database directory")
    p.add_argument("-r", "--reference", required=True, help="Reference genome FASTA")
    p.add_argument("-l", "--loci", required=True,
                   help="BED file: chrom start end name")
    p.add_argument("-s", "--seqs", default=None,
                   help="Per-locus haplotype FASTA pattern with {} for locus name")
    p.add_argument("-v", "--vcf", default=None,
                   help="Pangenome VCF with phased sample genotypes: haplotypes "
                        "are reconstructed from the reference + variants "
                        "(panvcf.rs)")
    p.add_argument("--leave-out", nargs="*", default=(),
                   help="Samples to exclude from VCF haplotype extraction")
    p.add_argument("-k", "--kmer", type=int, default=25,
                   help="k-mer size for counts [%(default)s]")
    p.add_argument("-e", "--expand", type=int, default=0, metavar="BP",
                   help="Expand locus boundaries up to BP into variant-free, "
                        "unique-k-mer-rich positions (add.rs:330-477) "
                        "[disabled]")
    p.add_argument("-w", "--window", type=int, default=500,
                   help="Moving window for boundary selection [%(default)s]")
    p.add_argument("-u", "--unknown", type=float, default=0.1,
                   help="Max fraction of unknown genotypes per VCF haplotype "
                        "before it is discarded [%(default)s] (add.rs -u)")
    p.add_argument("--only-seqs", action="store_true",
                   help="Store haplotype sequences only: skip k-mer counts "
                        "and divergence matrices (add.rs --only-seqs)")
    p.add_argument("--rerun", default="none", help="all/part/none")
    return p


def discard_identical(names, seqs):
    """(add.rs:505-541): keep the first of each identical-sequence group."""
    seen = {}
    keep, discarded = [], []
    for i, (name, seq) in enumerate(zip(names, seqs)):
        key = seq.tobytes()
        if key in seen:
            discarded.append((name, names[seen[key]]))
        else:
            seen[key] = i
            keep.append(i)
    return keep, discarded


def divergence_matrix(seqs, k=15, w=10) -> np.ndarray:
    """All-pairs minimizer Jaccard distances (seq/div.rs:45-110)."""
    sets = [sorted_minimizer_set(s, k, w) for s in seqs]
    n = len(seqs)
    out = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            _, d = jaccard_distance(sets[i], sets[j])
            out[i, j] = out[j, i] = d
    return out


def build_locus(db_dir: Path, locus_name: str, hap_names, hap_seqs,
                genome_counter: GenomeKmerCounter, target_seq: np.ndarray,
                ref_interval=None, only_seqs: bool = False) -> None:
    ldir = paths.locus_dir(db_dir, locus_name)
    ldir.mkdir(parents=True, exist_ok=True)

    keep, discarded = discard_identical(hap_names, hap_seqs)
    if discarded:
        with open(ldir / paths.DISCARDED, "w") as f:
            for name, kept_as in discarded:
                f.write(f"{name}\t=\t{kept_as}\n")
        logger.info("[%s] discarded %d identical haplotypes", locus_name,
                    len(discarded))
    hap_names = [hap_names[i] for i in keep]
    hap_seqs = [hap_seqs[i] for i in keep]

    if not only_seqs:
        kc = off_target_counts(genome_counter, hap_seqs, target_seq)
        kc.save_npz(ldir / paths.KMER_COUNTS)

        div = divergence_matrix(hap_seqs)
        np.savez_compressed(ldir / paths.DISTANCES, div=div,
                            names=np.array(hap_names))

    with smart_create(ldir / paths.HAPLOTYPES) as f:
        for name, seq in zip(hap_names, hap_seqs):
            fastx.write_fasta(f, name, seq)
    if ref_interval is not None:
        with open(ldir / paths.REF_BED, "w") as f:
            f.write(f"{ref_interval[0]}\t{ref_interval[1]}\t{ref_interval[2]}"
                    f"\t{locus_name}\n")
    write_success(ldir)
    logger.info("[%s] %d haplotypes added", locus_name, len(hap_names))


def run(args):
    rerun = Rerun.parse(args.rerun)
    db = Path(args.db)
    genome = {}
    for name, codes in fastx.read_fasta(args.reference):
        genome[name] = codes
    logger.info("Loaded reference with %d contigs (%d bp)", len(genome),
                sum(len(s) for s in genome.values()))
    counter = GenomeKmerCounter(args.kmer)
    for codes in genome.values():
        counter.add_seq(codes)
    counter.finalize()

    n_done = 0
    with open(args.loci) as f:
        for line in f:
            fields = line.split()
            if not fields or fields[0].startswith("#"):
                continue
            chrom, start, end, name = fields[0], int(fields[1]), int(fields[2]), fields[3]
            ldir = paths.locus_dir(db, name)
            if not rerun.prepare_dir(ldir):
                logger.info("[%s] already done, skipping", name)
                continue
            if args.expand > 0:
                from .boundary import expand_locus
                res = expand_locus(genome[chrom], start, end, counter,
                                   allowed_expansion=args.expand,
                                   moving_window=args.window)
                if res is None:
                    logger.warning("[%s] no valid expanded boundary, keeping "
                                   "original", name)
                else:
                    if res != (start, end):
                        logger.info("[%s] expanded %s:%d-%d -> %d-%d", name,
                                    chrom, start, end, res[0], res[1])
                    start, end = res
            target_seq = genome[chrom][start:end]
            if args.vcf:
                from ..seq.panvcf import haplotypes_from_vcf
                named = haplotypes_from_vcf(args.vcf, target_seq, chrom,
                                            start, end,
                                            leave_out=args.leave_out,
                                            max_unknown_frac=args.unknown)
            elif args.seqs:
                hap_file = args.seqs.replace("{}", name)
                named = [(r.name, r.seq) for r in fastx.read_fastx_auto(hap_file)]
            else:
                raise SystemExit("Either --seqs or --vcf is required")
            build_locus(db, name, [n for n, _ in named], [s for _, s in named],
                        counter, target_seq, ref_interval=(chrom, start, end),
                        only_seqs=args.only_seqs)
            n_done += 1
    logger.info("Database build complete (%d loci processed)", n_done)
    return 0
