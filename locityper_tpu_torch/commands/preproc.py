"""`preproc` command: estimate background distributions from a WGS sample.

Counterpart of reference command/preproc.rs.  Only the command line is
here so far: the flags parse as the reference package's do, and `run`
raises.  A preprocessing directory written by the reference package
(bg/distr.json.gz) loads unchanged in `genotype`.
"""
from __future__ import annotations


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


def run(args):
    raise NotImplementedError(
        "preproc (background distributions of a WGS sample) is not ported "
        "yet — ROADMAP.md A9; a preprocessing directory written by the "
        "reference package's preproc loads unchanged")
