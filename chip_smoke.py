#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--resources]

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the port's
main path (recruitment, alignment and multi-stage solving, all on the GPU,
reference-default scheme) on simulated samples whose truth is known:

  (a)  a panel of 4 loci x 6 haplotypes of 4 kb, 15x paired reads plus ~10x
       off-locus background, written to two FASTQ files and recruited by
       `commands.genotype.recruit_reads_fast` (native parser, device batches
       of 32,768 pairs); the recruited reads must equal the host engine's;
  (a') the same files through the command line: `cli.main(["add", ...])`
       builds the database, `cli.main(["genotype", ...])` goes from FASTQ to
       res.json.gz and the BAM and SAM files of the best genotype
       (`--out-bams 1 --out-sams 1`), and `genotype --stop-after map` writes
       every candidate alignment to aln.bam and aln.sam.gz; the files are
       read back with the port's BAM reader;
  (b)  one HLA-scale locus: 200 haplotypes in 10 clades, 20,100 genotypes at
       the stage-0 filter, recruited by `pipeline.recruit_records`
       (the iterator entry, device pair batches);
  (c)  a long-read panel: 3 loci x 4 haplotypes of 16,384 bp, single reads
       of 12,000 +- 2,000 bases at 10x plus 5x background, recruited by
       `recruit_records` in long device batches, aligned at band 160;
  (d)  a WGS-like sample through the command line, `add`, `preproc` and
       `genotype`: one contig of 9,000,000 bases of varying GC with the
       loci of (a) in its first 2 Mb, and about 450,000 read pairs (150 bp,
       insert N(400, 60), 0.2 % substitutions) from two copies of it, each
       carrying one haplotype of the true genotype at each locus, at 7.5x
       a copy, in two gzip FASTQ files.  `preproc` recruits the whole input
       to its default background region (the central 4.5 Mb) and estimates
       from 200,000 pairs of it; the estimated insert mean, depth and
       mismatch rate must be near the simulated ones, and every call equal
       the truth.
  (a-seq) the files of (a') through `genotype` once more under the
       sequential engine, `-S greedy:i=5k,a=1,e=seq anneal:i=20,a=20,e=seq`
       (the reference greedy, then one Metropolis chain an attempt; plain
       PyTorch on the card, no kernel of its own): every call must equal the
       truth and the chains engine's call of (a'), and the annealer kernel
       must not be launched;
  (e)  extra/validate_stream_100k.py's case rebuilt with the port's
       `sim.py`: one locus of 98,304 bp (4 haplotypes, 1 % divergence)
       between random flanks of 50 kb, ONT-like single reads (2 % / 0.8 % /
       0.8 % errors) of 20 +- 5 kb at 8x, at least 8 reads of 65,537 to
       98,304 bases, and 4x of background from the left flank, recruited by
       `recruit_records` (full-width front end at rows of 131,072), aligned at
       band 160 on rows longer than 65,536, default scheme.
  (f)  extra/panel_setup.py:make_panel(100) rebuilt with the port's
       `sim.py`: 100 loci x 6 haplotypes of 4 kb between 101 random flanks
       of 20 kb, 15x pairs from each locus's true genotype (~40,000, drawn
       by `simulate_paired_reads`) and ~1,010,000 background pairs from the
       flanks (10 x 15x, drawn by `sample_pairs`), in two gzip FASTQ files;
       `cli.main(["add", ...])` builds the database and `genotype` (default
       scheme) goes from FASTQ to 100 res.json.gz.  Its recruitment index
       has ~159,000 keys and 4 bitmap words a key (`n_groups` 4).  Every
       call must equal the truth; the command line's recruited reads of
       the first 131,072 pairs are held against the host engine.
  (g)  extra/hla_scale.py's panel (its defaults, seed 0) rebuilt with the
       port's `sim.py`: 5 loci of 4 kb, each 200 haplotypes in 10 clades
       (20,100 genotypes at the stage-0 filter), 15x pairs from each true
       genotype plus 15x background from the 6 random flanks of 20 kb (8,000
       pairs), in two gzip FASTQ files; `cli.main(["add", ...])` builds the
       database and `genotype` (default scheme) goes from FASTQ to 5
       res.json.gz.  Every call must equal the truth; the command line's
       recruited reads are held against the host engine on every pair.
  (g-2proc) (g)'s `genotype` once more as two processes of the port's
       command line on the one card (MASTER_ADDR, MASTER_PORT, WORLD_SIZE 2
       and RANK 0 and 1 in their environment, one output directory): both
       must exit 0, split the loci 3 and 2 by the cost-weighted LPT rule,
       genotype each locus once, and call (g)'s genotypes; each process's
       wall seconds and launches are printed.
  (h)  BASELINE.json config 3, a CYP2D6/CYP2D7-like locus: one locus of
       5,000 bp, 8 haplotypes in 2 clades (2 % between clades, 0.3 %
       within), and its paralog at 97 % identity (`sim.make_paralog`) 10 kb
       downstream on one contig between random flanks of 20 kb; `add` sees
       the whole contig, so the off-target k-mer counts see the paralog.
       15x pairs from the true genotype, 2 x 15x from the paralog (both
       sample copies) and 10x from the flanks; `genotype` (default scheme)
       must call the truth, recruit reads of the paralog (else the sample
       is no stress) and recruit the host engine's reads.
  (h-P3) (h)'s database, reads from three distinct haplotypes at 15x each
       plus the paralog and the flanks, `genotype -P 3`: the call must equal
       the truth; the annealer's largest launches of this path are held
       against the plain version (polish only whole, the stage-2 launch
       with its schedule cut to 2,000 + 1,000 steps).
  (h-P1) a haploid sample (tests/test_pipeline.py:147-162: both copies of
       one haplotype) on (h)'s database, `genotype -P 1`, held the same way.
  (h-w) (h)'s files with `--reg-weights`, every haplotype weighted 0.1 over
       its middle half: the call must equal the truth, and the top
       likelihood must differ from (h)'s.
  (i)  BASELINE.json config 4's HiFi half: one locus of 16,384 bp with 4
       haplotypes at 1.2 % divergence between flanks of 50 kb, HiFi-like
       single reads of 15,000 +- 2,000 bases (0.1 % errors), 10x from each
       haplotype of the true genotype and from each of two copies of the
       flanks (one depth a copy), through `add`, `preproc --tech
       hifi -b <the left flank> --max-reads 2000` and `genotype`; the call
       must equal the truth and the recruited reads the host engine's; the
       aligner's widest launches of `preproc` (band 48) and of `genotype`
       (band 160) are held on 8 jobs each.

  (j)  (d)'s contig, loci and pairs as users hold a WGS sample: a
       coordinate-sorted CRAM against (d)'s ref.fa and its BAM twin, each
       mate at its place on the contig (a pair of a locus at the locus's
       start plus its offset in the haplotype), the fragment's reverse end
       with flag 0x10 in contig orientation, one in ten pairs of the loci
       unmapped at the end; both indexed by the port's `index`.  `preproc
       -a wgs.cram -r ref.fa` fetches (d)'s background region through the
       .crai (its estimates within (d)'s bounds); `genotype -i wgs.cram -r
       ref.fa` fetches the loci's padded regions and the unplaced tail:
       every call must equal the truth, the recruited reads the host
       engine's over the same fetched stream and include unplaced pairs;
       `genotype -i wgs.bam -r ref.fa --stop-after recruit` must recruit
       the same reads.
  (a-m16) the files of (a') through `genotype -m 16,10`: 32-bit k-mers in
       the front end; every call must equal the truth and (a')'s, and the
       largest k = 16 launch of the front end is held against the plain
       version and timed.
  (a-priors) the same through `genotype --priors`: for each locus the
       truth, two other genotypes and one at -inf; every call must equal
       the truth and (a')'s, and the options listed be the file's finite
       genotypes.
  (a-knobs) the same through `genotype` with the model knobs (`-A 0.5 2 3
       -U -8 --tweak 40 --min-weight 0.01 --kmers-weight 0.3,3
       --compl-weight 0.4,3 --read-kmers 1,6`), then with the filter knobs
       and the debug files (`--filt-diff 50 --prob-thresh -3 --dont-skip
       --debug 2`): every call must equal the truth and (a')'s, and the
       three debug files exist for every locus.
  (a-profile) the same through `genotype --profile <dir>`: every call must
       equal the truth and (a')'s, and the trace the command line writes
       (`torch.profiler`, CUDA activity) must name at least one launch of
       K1, K2 and K3.
  (k)  BASELINE.json config 4's ONT half over config 3's locus: (h)'s gene,
       spacer and paralog with their flanks lengthened (108 kb before the
       locus, 50 kb after the paralog), the locus widened to hold 12 kb
       reads (8 kb of flank, the gene, the spacer, the paralog, 8 kb: 36
       kb); ONT-like single reads (2 % / 0.8 % / 0.8 %) of 12,000 +- 2,000
       bases at 10x from each of two copies, each with one true haplotype
       (seed 11), so that reads span the gene, the spacer and the paralog;
       `add`, `preproc --tech ont -b chr1:1-50000 --max-reads 2000`, once
       more with `-q 0`, and `genotype`: the call must equal the truth, the
       recruited reads the host engine's, reads over the paralog be among
       them, the estimates say `ont`, the read length within 5 % of the
       sample's, the mismatch rate within a factor 2 of 2 %, the `-q 0`
       depth within 25 % of 10x a copy and the default's no higher (both
       packages drop a long read from the depth count when its two
       candidate windows give one alignment).  K5, K1 (8 jobs) and K2 are
       held on (k)'s widest launches of `preproc` and `genotype`.
  (k-bam) (k)'s reads as an aligner leaves them in a sorted ont.bam (each
       read at its place with `<len>M`, reverse reads with flag 0x10 in
       contig orientation), indexed by the port's `index`; `preproc -a
       ont.bam --tech ont` and `genotype -i ont.bam`: the call must equal
       the truth and (k)'s, the recruited reads (k)'s among the reads the
       index fetch yields, and the estimates lie within 10 % of (k)'s.

  (a-mesh) the files of (a') through `genotype` with
       `parallel.mesh.auto_mesh` returning a 2 x 2 grid of 4 shards on card
       0 (restored afterwards): recruitment, alignment and both solver
       stages split over the shards; the recruited reads must equal (a')'s
       name by name and every call (a')'s.  Where `auto_mesh()` itself
       gives a grid (2, 4, ... cards), (a-mesh) runs once more over it.
  (a-batched) the files of (a') through `genotype -S
       greedy:i=5k,a=1,e=batched anneal:i=20,a=20,e=batched` (the
       batched-move engine, plain PyTorch): every call must equal (a')'s,
       and the annealer kernel must not be launched;
  (b-mesh) (b) at full width over the grid of (a-mesh); afterwards
       `sharded_align` on all its alignment jobs must equal one device on
       every output, the read-sharded stage-0 scores of its 20,100
       genotypes lie within 1e-5 relative of the host's and keep the same
       genotypes, each shard of its first stage chunk equal one launch of
       the annealer on that shard's rows with that shard's seed, and
       `parallel.mesh.full_step` (the multi-device dry run) equal one
       device.

Before the samples, the sequential engine runs on the card against the CPU
on tests/test_ilp.py's problems: its greedy must give equal assignments and
likelihoods within 1e-4 on both, and its annealing chain must reach the ILP
optimum on the card; the batched-move engine must reach within 0.05 of the
optimum on the card and on the CPU.  The card count
(`torch.cuda.device_count()`) is printed after the card's name.

Every call must equal the simulated truth.  The launch counts are set to 0
just before each sample and read just after it, and each kernel must have
been launched in each sample that needs it; the processes of (g-2proc)
start with counts of 0, print theirs when they end, and each must have
launched every kernel of (g), while this process launches none meanwhile
(their sum is (g-2proc)'s entry in `launches_by_path`).  The script needs a
CUDA device (it exits with a non-zero code without one), imports neither
`jax` nor the JAX package, needs no network and starts no process that
outlives it (`nvcc`, `make`, `nvidia-smi` and the processes of (g-2proc)
are waited for, the latter killed after WORLD_TIMEOUT seconds).

Output: one line per phase; then a JSON line `{"kernels": [...]}` with, for
each kernel, its launches on the main path (`launches`, the sum of
`launches_by_path`), its time on the inputs of the largest launch the main
path made of it (`ms`, CUDA events, warm, median of 5), the plain version's
time on the same inputs (`plain_ms`), the largest absolute difference
between the two (`max_abs_err`) and the least time the card could take for
the same work (`bound_ms`); last, the contract line
`{"ok": true, "device": {...}}`.  The annealer runs in two modes on the main
path (Metropolis steps then polish, and polish only); its largest launch of
each mode is held against the plain version, exactly, and timed, and the
entry's `modes` carries both, and (h-P3)'s and (h-P1)'s own launches at
ploidy 3 and 1 (`polish_P3`, `anneal_P3`, `anneal_P1`; the anneal ones
held with the schedule cut, `whole_ms` the kernel on the whole launch).
`align_banded` carries `long_rows`: its largest main-path launch on rows
longer than 8,192 outside (e) and (i) (sample (c)), where the reference
package switches to a second, row-streamed TPU kernel and this port keeps
launching the one kernel; `long_rows` also carries the 8 jobs held of
(e)'s widest launch and of (i)'s in `preproc` and in `genotype`.  All
three kernels were redesigned after their first port; the earlier design's time on the same launch
(constants below, with their origin) is printed on the kernel's own line
beside the time of this run, and is not part of the JSON line, which holds
only what this run measured.  The annealer walks a
chain 32 steps at a time and evaluates again the moves that an accepted
earlier move of the batch disturbs: the mean number of evaluation rounds a
batch (`rounds_per_batch`, 1 to 32) is printed with each timed launch.
`minimizer_front` is one source with two entries, `compact` and `full`;
each is a launch count of its own and the kernel entry's `entries` carries
both.  The main path's launches at k = 15 give `compact`'s numbers;
(a-m16)'s largest launch at k = 16 is held and timed apart, as `compact`'s
`k16` (with its launch count).

How `bound_ms` is counted.  It is the larger of bytes / 3.35e12 B/s and
operations / 67e12 op/s (H100 SXM: HBM3 rate and float32 rate outside the
tensor cores; all kernels do scalar float32/int32 work only).
  align_banded: bytes = every read, window, length and score read once,
    the eight [N] outputs written once.  Operations = band cells of the rows
    that this run's reads really have (sum of min(len, L) over jobs) x the
    operations of one cell, counted in the header of align_banded.cu.
  anneal_chains: bytes = all ten inputs read once, likelihood, assignment
    and step count written once.  Operations = moves that this run's chains
    really proposed (the kernel reports them; a frozen chain stops) x the
    operations of one move, counted in the header of anneal_chains.cu; plus
    one add per window and per read for the final likelihood.
  minimizer_front: bytes = the codes read once, hs (4 bytes), is_fw and
    mask (1 byte each) written once for every output column, and for the
    compacting entry 4 bytes of `total` a row.  Operations = positions
    B x (L - k + 1) x the operations of one position, counted in the header
    of minimizer_front.cu (26 + 4 (w - 1)).
No single PyTorch call computes any of these functions, so `library_ms` is
null.

With `--profile`, samples (b) and (a), the recruit phases of (a) and (c)
alone, the `preproc` of (d) and the `genotype` of (f) are run once more
under `torch.profiler`
after everything else, and the device's busy share of each run and the
device time by kernel name are printed (before the two closing JSON lines);
the `preproc` of (d) runs a third time under cProfile, which prints the
package's functions with the most host time.  With `--resources`, every source is
compiled once more with `-Xptxas -v` right after the build, and the
registers and the spilled bytes of every kernel instantiation are printed.
"""
import gzip
import itertools
import json
import logging
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch

from locityper_tpu_torch import _kernels, cli, sim
from locityper_tpu_torch.bg import BgDistr, SequencingInfo, Technology
from locityper_tpu_torch.bg.depth import ReadDepth
from locityper_tpu_torch.bg.err_prof import (EditDistCache, EditThresh,
                                             ErrorProfile)
from locityper_tpu_torch.bg.insertsz import InsertDistr
from locityper_tpu_torch.commands import genotype as G
from locityper_tpu_torch.mathx.distr import NBinom
from locityper_tpu_torch.model import Params
from locityper_tpu_torch.model.assgn import LocusTensors
from locityper_tpu_torch.model import locs as LC
from locityper_tpu_torch.model.locs import build_all_alignments_panel
from locityper_tpu_torch.model.windows import ContigInfoPack
from locityper_tpu_torch.ops import align as A
from locityper_tpu_torch.ops import recruit as R
from locityper_tpu_torch.ops import solver as SQ
from locityper_tpu_torch.ops import solver_batched as SB
from locityper_tpu_torch.ops import solver_chains as SC
from locityper_tpu_torch.ops.solver import SolverConfig, build_bayes_table
from locityper_tpu_torch.parallel import mesh as M
from locityper_tpu_torch.pipeline import (LocusData, genotype_panel,
                                          recruit_records)
from locityper_tpu_torch.pipeline import recruit_reads as host_recruit_reads
from locityper_tpu_torch.seq import bam as tbam
from locityper_tpu_torch.seq import fastx, inputs
from locityper_tpu_torch.seq.contigs import ContigSet
from locityper_tpu_torch.seq.counts import GenomeKmerCounter, off_target_counts
from locityper_tpu_torch.seq.cram import CramWriter
from locityper_tpu_torch.seq.recruit import RecruitParams, TargetIndex
from locityper_tpu_torch.solvers import ilp
from locityper_tpu_torch.solvers.solve import (Scheme, _unpermute_assignments,
                                               run_filter, select_by_scores)
from locityper_tpu_torch.utils import paths
from locityper_tpu_torch.utils.rng import derive_seed

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_OPS_PER_CELL = 52          # counted in the header of align_banded.cu
K2_OPS_PER_MOVE = 232         # counted in the header of anneal_chains.cu
K3_OPS_FIXED, K3_OPS_PER_NEIGHBOUR = 26, 4  # header of minimizer_front.cu
LONG_ROWS = 8192              # above this the reference streams rows (K4)
# Times of the first designs of the kernels (one thread a chain; one warp a
# job with the best end searched in every row; one block a read row) on the
# main path's largest launches, as this script read them on an NVIDIA H100
# 80GB HBM3, 700.00 W, before the redesign: ms a launch.  The annealer's
# were read on launches of EARLIER_CHAINS chains; since (f) the main path's
# largest Metropolis launch has more.
EARLIER_MS = {"align_banded": 1.970, "align_banded_long_rows": 18.974,
              "anneal_chains_anneal": 43.766, "anneal_chains_polish": 2.729,
              "minimizer_front_compact": 0.320, "minimizer_front_full": 0.173}
EARLIER_CHAINS = {"anneal": 1600, "polish": 512}
DEPTH = 15.0
BACKGROUND_MULTIPLE = 10        # (a): off-locus read mass / locus flanks
WGS_CONTIG = 9_000_000          # (d): one contig; preproc's background is
WGS_LOCUS_GAP = 400_000         # its central 4.5 Mb; loci every 400 kb
WGS_DEPTH = 7.5                 # (d): depth of each of the two copies
WGS_SUB_RATE = 0.002            # (d): substitutions a base
SEQ_SCHEME = ["greedy:i=5k,a=1,e=seq", "anneal:i=20,a=20,e=seq"]
BATCHED_SCHEME = ["greedy:i=5k,a=1,e=batched", "anneal:i=20,a=20,e=batched"]
GRID = 4                        # (a-mesh), (b-mesh): 2 x 2 shards on one card
BIG_LOCUS = 98_304              # (e): extra/validate_stream_100k.py
BIG_READS = (65_536, 98_304)    # (e): longer than the first, at most the second
PANEL_LOCI = 100                # (f): extra/panel_setup.py:make_panel(100)
PANEL_HOST_PAIRS = 131_072      # (f): pairs held against the host engine
HLA_LOCI = 5                    # (g): extra/hla_scale.py's defaults
WORLD = 2                       # (g-2proc): processes on the one card
WORLD_TIMEOUT = 900             # (g-2proc): seconds before they are killed
PARALOG_LOCUS = 5000            # (h): the CYP2D6/CYP2D7-like locus, bp
PARALOG_IDENTITY = 0.97         # (h): its paralog (sim.make_paralog)
K2_CUT = (2000, 1000)           # (h-P3), (h-P1): anneal and polish steps of
                                # the stage-2 launch held against plain
HIFI_LOCUS = 16_384             # (i): bp
UNPLACED_EVERY = 10             # (j): one in this many locus pairs unmapped
K_BG = 50_000                   # (k): preproc -b chr1:1-K_BG
K_LEFT = 100_000                # (k): bases before the locus, K_BG + preproc's
                                # 50 kb padding
K_RIGHT = 50_000                # (k): the right flank, from the paralog's end
K_MARGIN = 8_000                # (k): of each flank inside the widened locus
ONT_READS = (12_000, 2_000)     # (k): read length, mean and sd ((c)'s)
ONT_ERRORS = (0.02, 0.008, 0.008)   # (k): mismatch, insertion, deletion ((e)'s)
ONT_DEPTH = 10.0                # (k): a copy
MODEL_KNOBS = ["-A", "0.5", "2", "3", "-U", "-8", "--tweak", "40",
               "--min-weight", "0.01", "--kmers-weight", "0.3,3",
               "--compl-weight", "0.4,3", "--read-kmers", "1,6"]
FILTER_KNOBS = ["--filt-diff", "50", "--prob-thresh", "-3", "--dont-skip",
                "--debug", "2"]
DEBUG_FILES = ("windows.bed.gz", "sol.csv.gz", "read_pairs.csv.gz")


class Failed(Exception):
    """A phase did not hold."""


def check(cond, what):
    if not cond:
        raise Failed(what)


def time_ms(fn, reps=5):
    """Median CUDA-event time of `fn` over `reps` warm launches; a 64 MiB
    write between launches pushes the inputs out of the 50 MB L2."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# -- K1 --------------------------------------------------------------------

def make_align_jobs(seed, N, L, band):
    """Reads cut from a random haplotype with substitutions, N bases, short
    reads and one insertion or deletion of up to 39 bases in 30 % of jobs."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 4, 400_000).astype(np.int8)
    start = rng.integers(band, hap.size - 2 * L - 100, N)
    ar = np.arange(L)[None, :]
    cut = rng.integers(10, L - 10, N)[:, None]
    gap = np.where(rng.random(N) < 0.3, rng.integers(1, 40, N), 0)[:, None]
    sign = np.where(rng.random(N) < 0.5, 1, -1)[:, None]
    reads = hap[start[:, None] + ar + (ar >= cut) * gap * sign]
    sub = rng.random((N, L)) < 0.01
    reads = np.where(sub, (reads + rng.integers(1, 4, (N, L))) % 4,
                     reads).astype(np.int8)
    reads[rng.random((N, L)) < 0.001] = 4
    lens = np.where(rng.random(N) < 0.3, rng.integers(L // 2, L, N),
                    L).astype(np.int32)
    reads[ar >= lens[:, None]] = 4
    wins = hap[(start - band // 2)[:, None] + np.arange(L + band)[None, :]]
    return tuple(torch.from_numpy(x).cuda() for x in (reads, lens, wins))


def align_bound_ms(reads, lens, wins, band):
    N, L = reads.shape
    moved = nbytes(reads, lens, wins) + 5 * 4 + N * (4 + 6 * 4 + 1)
    rows = int(torch.clamp(lens, max=L).sum())
    ops = rows * band * K1_OPS_PER_CELL
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def make_edge_jobs(seed, N, L, band, gap=2, tail=5):
    """Jobs of `make_align_jobs` of which every 7th has an empty read
    (len 0) and every 5th is the window's own diagonal with `gap` bases
    deleted `tail` bases before the read's end, so that the best end, in
    the last row, carries a deletion's payload."""
    reads, lens, wins = make_align_jobs(seed, N, L, band)
    ar = torch.arange(L, device="cuda")[None, :]
    late = torch.arange(4, N, 5, device="cuda")
    col = band // 2 + ar + (ar >= L - tail) * gap
    reads[late] = torch.gather(wins[late], 1, col.expand(late.numel(), L))
    lens[late] = L
    empty = torch.arange(0, N, 7, device="cuda")
    reads[empty] = 4
    lens[empty] = 0
    return reads, lens, wins, late, empty


def compare_align(reads, lens, wins, sv, band, what, timed=True,
                  all_valid=True):
    """Kernel vs plain version on the card: all eight outputs bit-identical.
    Returns a dict of measurements."""
    got = A.align_banded(reads, lens, wins, sv, band)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = A.align_batch_reference(reads, lens, wins, sv, band)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for k in A.ALIGN_RESULT_KEYS:
        n_bad = int((got[k] != want[k]).sum())
        check(n_bad == 0, f"align_banded {what}: {n_bad} jobs differ in {k}")
    check(bool(got["valid"].all()) or not all_valid,
          f"align_banded {what}: invalid jobs")
    err = float((got["score"] - want["score"]).abs().max())
    ms = time_ms(lambda: A.align_banded(reads, lens, wins, sv, band)) \
        if timed else None
    bound_ms, bound_by = align_bound_ms(reads, lens, wins, band)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                bound_by=bound_by, got=got,
                shape=[int(reads.shape[0]), int(reads.shape[1]), band])


def phase_k1_edges(sv):
    """An odd number of jobs (at band 48 the last half warp has none), empty
    reads, and a deletion carried into the best end of the last row."""
    for N, L, band in ((4097, 128, 48), (1025, 128, 160)):
        reads, lens, wins, late, empty = make_edge_jobs(N + band, N, L, band)
        r = compare_align(reads, lens, wins, sv, band,
                          f"{N}x{L} band {band}, edge cases", timed=False,
                          all_valid=False)
        got = r["got"]
        check(not bool(got["valid"][empty].any())
              and bool((got["score"][empty] == A.NEG).all())
              and not bool(got["end_p"][empty].any()),
              f"align_banded band {band}: an empty read has a result")
        n_late = int(((got["n_del"][late] == 2)
                      & (got["end_p"][late] == band // 2 + L + 2)).sum())
        check(n_late > late.numel() // 2,
              f"align_banded band {band}: {n_late} of {late.numel()} late "
              "deletions found")
        print(f"K1 {N} jobs L={L} band={band}, {empty.numel()} empty reads, "
              f"{n_late} best ends after a late deletion: all 8 outputs "
              "bit-identical", flush=True)


# -- K2 --------------------------------------------------------------------

def small_problem(seed, n_reads=40, n_haps=3, kh=3):
    """A problem small enough for the exact ILP oracle (tweak = 0)."""
    rng = np.random.default_rng(seed)
    hap_len, window, n_win = 1500, 100, 8
    hap_prob = rng.normal(-4.0, 2.0, (n_haps, n_reads, kh)).astype(np.float32)
    hap_prob[rng.random((n_haps, n_reads, kh)) < 0.35] = -1e30
    mid = rng.integers(0, hap_len, (n_haps, n_reads, kh, 2)).astype(np.int32)
    mid[rng.random((n_haps, n_reads, kh, 2)) < 0.15] = -1
    tensors = LocusTensors(hap_prob, mid, np.full(n_reads, -30.0, np.float32),
                           n_haps, n_reads, kh)
    pack = ContigInfoPack(
        n_haps=n_haps, max_len=hap_len, max_windows=32,
        n_windows=np.full(n_haps, n_win, np.int32),
        reg_start=np.full(n_haps, (hap_len - n_win * window) // 2, np.int32),
        contig_len=np.full(n_haps, hap_len, np.int32), window_size=window,
        gc_at=rng.integers(35, 60, (n_haps, hap_len)).astype(np.int32),
        weight_at=rng.uniform(0.6, 1.0, (n_haps, hap_len)).astype(np.float32))
    bayes = build_bayes_table([NBinom(4.0, 0.45)] * 101, [0.3, 2.0, 3.0], 2.0)
    return tensors, pack, bayes, Params(tweak=0)


def prepare_chains(tensors, pack, bayes, cfg, gts, attempts, random_init,
                   seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f32, i32 = torch.float32, torch.int32
    args = ((tensors.hap_prob, f32), (tensors.hap_mid, i32),
            (tensors.unmapped_prob, f32), (pack.n_windows, i32),
            (pack.reg_start, i32), (pack.contig_len, i32), (pack.gc_at, i32),
            (pack.weight_at, f32), (bayes, f32))
    targs = [torch.as_tensor(a).to(dev, dt) for a, dt in args]
    return SC._prepare_chains(gen, torch.as_tensor(gts).to(dev), attempts,
                              *targs, cfg, pack.max_windows, random_init)


def random_chains(seed, G, A, R, K, W, D):
    """Random inputs of `anneal_chains` on the card, any shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C, i32 = G * A, torch.int32
    probs = -4 * torch.rand((G, R, K), generator=g, device="cuda")
    w = torch.randint(0, W, (C, R, K, 2), generator=g, device="cuda",
                      dtype=i32)
    winpk = w[..., 0] | (w[..., 1] << 16)
    vcount = torch.randint(1, K + 1, (G, R), generator=g, device="cuda",
                           dtype=i32)
    nontrivial = vcount > 1
    nt_ixs = torch.argsort((~nontrivial).to(torch.uint8), dim=1,
                           stable=True).to(i32)
    ntc = nontrivial.sum(1).clamp_min(1).to(i32)
    start_temp = torch.full((G,), 5.0, device="cuda")
    wtab = -torch.rand((C, W, D), generator=g, device="cuda")
    assgn0 = torch.zeros((C, R), dtype=i32, device="cuda")
    depth0 = torch.zeros((C, W), dtype=i32, device="cuda")
    ones = torch.ones((C, R), dtype=i32, device="cuda")
    depth0.scatter_add_(1, (winpk[:, :, 0] & 0xFFFF).long(), ones)
    depth0.scatter_add_(1, (winpk[:, :, 0] >> 16).long(), ones)
    cache0 = torch.gather(wtab, 2, depth0.clamp(0, D - 1).long()[..., None])
    return (probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab, assgn0,
            depth0, cache0[..., 0])


def anneal_bound_ms(chain_args, lik, assgn, steps):
    C, W = chain_args[6].shape[0], chain_args[6].shape[1]
    R = assgn.shape[1]
    moved = nbytes(*chain_args) + nbytes(lik, assgn, steps)
    ops = int(steps.sum()) * K2_OPS_PER_MOVE + C * (W + R)
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def compare_anneal(chain_args, kw, what, timed=False):
    """Kernel vs plain annealer on the card, same inputs, same stream: equal
    assignments, step counts and likelihoods, whatever the mode."""
    schedule = torch.zeros(2, dtype=torch.int64, device="cuda")
    lik, assgn, steps = SC.anneal_chains(*chain_args, schedule=schedule, **kw)
    rounds, batches = schedule.tolist()             # waits for the device
    t0 = time.perf_counter()
    p_lik, p_assgn, p_steps = SC.anneal_chains_reference(*chain_args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_bad = int((assgn != p_assgn).sum())
    err = float((lik - p_lik).abs().max())
    check(n_bad == 0, f"anneal_chains {what}: {n_bad} assignments differ")
    check(err == 0.0, f"anneal_chains {what}: likelihoods differ {err}")
    check(bool((steps == p_steps).all()),
          f"anneal_chains {what}: step counts differ")
    ms = time_ms(lambda: SC.anneal_chains(*chain_args, **kw)) if timed \
        else None
    bound_ms, bound_by = anneal_bound_ms(chain_args, lik, assgn, steps)
    C, R, K = chain_args[1].shape
    check(batches <= rounds <= 32 * batches,
          f"anneal_chains {what}: {rounds} rounds in {batches} batches")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                bound_by=bound_by, moves=int(steps.sum()), lik=lik,
                assgn=assgn, steps=steps,
                rounds_per_batch=rounds / max(batches, 1),
                shape=dict(C=C, R=R, K=K, W=int(chain_args[6].shape[1]),
                           n_steps=kw["n_steps"],
                           anneal_steps=kw["anneal_steps"],
                           plato=kw["plato"]))


def cut_schedule(kw, anneal, polish):
    """A launch's keywords with its schedule cut to `anneal` + `polish`
    steps (the cooling over the first `anneal`) and its plateau scaled
    alike: the plain version's time grows with the steps."""
    n_steps = anneal + polish
    plato = kw["plato"] * n_steps // max(kw["n_steps"], 1)
    return dict(kw, n_steps=n_steps, anneal_steps=min(kw["anneal_steps"],
                                                      anneal),
                plato=max(plato, 1) if kw["plato"] else 0)


def anneal_kw(cfg, attempts, n_steps, plato, seed):
    return dict(attempts=attempts, n_steps=n_steps,
                anneal_steps=cfg.anneal_steps, dc=float(cfg.depth_contrib),
                ac=float(cfg.aln_contrib), plato=plato,
                ln_init_prob=float(np.log(cfg.init_prob)), seed=seed)


def phase_k2():
    tensors, pack, bayes, params = small_problem(1)
    gts = np.array([(a, b) for a in range(3) for b in range(a, 3)], np.int64)
    base = dict(depth_contrib=params.depth_contrib,
                aln_contrib=params.aln_contrib, prob_diff=params.prob_diff,
                tweak=0, window_size=pack.window_size)

    cfg0 = SolverConfig(anneal_steps=0, polish_steps=0, **base)
    r = compare_anneal(prepare_chains(tensors, pack, bayes, cfg0, gts, 32,
                                      True, 3),
                       anneal_kw(cfg0, 32, 0, 0, 11), "0 steps")
    print(f"K2 n_steps=0: {r['shape']['C']} chains exact", flush=True)

    cfgp = SolverConfig(anneal_steps=0, polish_steps=2000, **base)
    args = prepare_chains(tensors, pack, bayes, cfgp, gts, 32, True, 4)
    for plato in (0, 300):
        r = compare_anneal(args, anneal_kw(cfgp, 32, 2000, plato, 12),
                           f"polish 2000, plato {plato}")
        print(f"K2 polish-only 2000 steps plato={plato}: "
              f"{r['shape']['C']} chains exact, {r['moves']} moves",
              flush=True)

    # The batched walk's corners: steps that are no multiple of 32, a
    # plateau shorter than a batch, one that ends inside a batch, a cooling
    # phase that ends inside a batch, chains that do not fill the last block.
    cfgs = SolverConfig(anneal_steps=700, polish_steps=1299, **base)
    args3 = prepare_chains(tensors, pack, bayes, cfgs, gts, 3, True, 6)
    for a, what, n_steps, plato in (
            (args, "1999 steps, cooling ends at 700", 1999, 0),
            (args, "31 steps", 31, 0),
            (args, "plateau 5", 1999, 5),
            (args, "plateau 77", 1999, 77),
            (args3, "18 chains, plateau 150", 1999, 150)):
        attempts = a[1].shape[0] // len(gts)
        r = compare_anneal(a, anneal_kw(cfgs, attempts, n_steps, plato, 14),
                           what)
        check(not plato or int(r["steps"].min()) < n_steps,
              f"anneal_chains {what}: no chain froze")
        print(f"K2 {what}: {r['shape']['C']} chains exact, {r['moves']} "
              f"moves, {r['rounds_per_batch']:.2f} rounds a batch",
              flush=True)
    # A chain's state takes 4 (R + 3 W) bytes of shared memory: at R 20,000
    # two chains fill a block (more than the 48 KB a kernel gets unasked);
    # at R 60,000 one chain fits no block, and the same kernel keeps the
    # state in global memory.
    for R, what in ((20_000, "two chains a block"),
                    (60_000, "state in global memory")):
        r = compare_anneal(random_chains(8, 2, 3, R, 2, 20, 8),
                           dict(attempts=3, n_steps=600, anneal_steps=300,
                                dc=1.85, ac=0.15, plato=3,
                                ln_init_prob=float(np.log(0.5)), seed=15),
                           what)
        check(int(r["steps"].min()) < 600,
              f"anneal_chains, {what}: no chain froze")
        print(f"K2 {what}, R={R}: {r['shape']['C']} chains exact, "
              f"{r['moves']} moves, {r['rounds_per_batch']:.2f} rounds a "
              "batch", flush=True)

    # Full default stage-2 shape: anneal 20k + polish 10k, 6 x 64 chains.
    cfga = SolverConfig(anneal_steps=20000, polish_steps=10000, **base)
    args = prepare_chains(tensors, pack, bayes, cfga, gts, 64, True, 5)
    kw = anneal_kw(cfga, 64, 30000, 10000, 13)
    r = compare_anneal(args, kw, "anneal 20k+10k", timed=True)
    lik = r["lik"].reshape(len(gts), 64).cpu().numpy()
    assgn = r["assgn"].reshape(len(gts), 64, -1).cpu().numpy()
    orig = _unpermute_assignments(assgn, gts, tensors, params)
    worst = 0.0
    for gi, gt in enumerate(gts):
        gt = tuple(int(h) for h in gt)
        _, ilp_lik = ilp.solve_ilp(gt, tensors, pack, bayes, params)
        check(abs(lik[gi].max() - ilp_lik) <= 1e-3,
              f"anneal_chains best {lik[gi].max()} != ILP optimum "
              f"{ilp_lik} for genotype {gt}")
        probs, wins, valid, win_gc, win_weight = ilp.assemble_genotype_host(
            gt, tensors, pack, bayes, params.prob_diff)
        for a in range(0, 64, 8):
            host = ilp.likelihood_of_assignment(
                orig[gi, a], probs, wins, win_gc, win_weight, bayes,
                params.depth_contrib, params.aln_contrib)
            worst = max(worst, abs(float(lik[gi, a]) - host))
    check(worst <= 1e-3, f"kernel likelihood vs host re-scoring: {worst}")
    print(f"K2 anneal 20k+10k: {r['shape']['C']} chains, kernel equals plain "
          f"exactly and reaches the ILP optimum of all {len(gts)} genotypes; "
          f"kernel vs host re-scoring max {worst:.2e}; "
          f"{r['ms']:.2f} ms/launch, "
          f"{r['moves'] / r['ms'] * 1e3:.3e} moves/s, "
          f"{r['rounds_per_batch']:.2f} rounds a batch "
          f"(plain {r['plain_ms']:.0f} ms)", flush=True)


# -- the sequential engine ---------------------------------------------------

def seq_solve(device, problem, gts, attempts, random_init, seed, **steps):
    tensors, pack, bayes, params = problem
    cfg = SolverConfig(depth_contrib=params.depth_contrib,
                       aln_contrib=params.aln_contrib,
                       prob_diff=params.prob_diff, tweak=0,
                       window_size=pack.window_size, **steps)
    liks, assgn = SQ.solve_genotypes(
        seed, gts, tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
        pack.n_windows, pack.reg_start, pack.contig_len, pack.gc_at,
        pack.weight_at, bayes, cfg, n_attempts=attempts,
        max_windows=pack.max_windows, random_init=random_init, device=device)
    return liks.cpu().numpy(), assgn.cpu().numpy()


def phase_seq():
    """The sequential engine (plain PyTorch, no kernel of its own) on the
    card: its greedy walks as on the CPU (float32 adds and multiplies of
    gathered values, counted draws), and its annealing chain reaches the
    exact ILP optimum of tests/test_ilp.py's problems (best of 64 attempts,
    4,000 + 4,000 steps), every likelihood equal to a host re-scoring."""
    problem = small_problem(1)
    gts = np.array([(a, b) for a in range(3) for b in range(a, 3)], np.int64)
    greedy = dict(anneal_steps=0, polish_steps=0, greedy_sample=10,
                  plato_size=100)
    t0 = time.perf_counter()
    card = seq_solve("cuda", problem, gts, 8, True, 3, **greedy)
    sync()
    t1 = time.perf_counter()
    host = seq_solve("cpu", problem, gts, 8, True, 3, **greedy)
    n_bad = int((card[1] != host[1]).sum())
    err = float(np.abs(card[0] - host[0]).max())
    check(n_bad == 0, f"seq greedy: {n_bad} assignments differ between the "
                      "card and the CPU")
    check(err <= 1e-4, f"seq greedy: likelihoods differ by {err}")
    print(f"seq greedy, {gts.shape[0]} genotypes x 8 attempts: equal "
          f"assignments on the card and the CPU, likelihoods within {err:.1e}"
          f"; {t1 - t0:.2f} s on the card", flush=True)
    worst = gap = 0.0
    t0 = time.perf_counter()
    for seed in (0, 1, 2):
        tensors, pack, bayes, params = problem = small_problem(seed)
        gt = (0, 2)
        _, ilp_lik = ilp.solve_ilp(gt, tensors, pack, bayes, params)
        liks, assgn = seq_solve("cuda", problem, np.array([gt]), 64, True,
                                seed, anneal_steps=4000, polish_steps=4000)
        best = float(liks.max())
        gap = max(gap, abs(best - ilp_lik))
        check(abs(best - ilp_lik) <= 1e-3 and best <= ilp_lik + 1e-3,
              f"seq chain best {best} != ILP optimum {ilp_lik} on problem "
              f"{seed}")
        probs, wins, valid, win_gc, win_weight = ilp.assemble_genotype_host(
            gt, tensors, pack, bayes, params.prob_diff)
        for a in range(0, 64, 8):
            check(valid[np.arange(assgn.shape[2]), assgn[0, a]].all(),
                  "seq chain: an invalid candidate")
            host = ilp.likelihood_of_assignment(
                assgn[0, a], probs, wins, win_gc, win_weight, bayes,
                params.depth_contrib, params.aln_contrib)
            worst = max(worst, abs(float(liks[0, a]) - host))
    check(worst <= 1e-3, f"seq chain likelihood vs host re-scoring: {worst}")
    print(f"seq chain 4,000 + 4,000 steps, 64 attempts, on the card: reaches "
          f"the ILP optimum of problems 0-2 (within {gap:.1e}); likelihood "
          f"vs host re-scoring max {worst:.1e}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_batched():
    """The batched-move engine (`e=batched`, plain PyTorch, no kernel of its
    own) on the card and on the CPU: tests/test_ilp.py:78's bar on
    small_problem, the best of 8 attempts of 1,000 super-steps (500 of
    cooling, a third of the accepted moves kept) within 0.05 of the exact
    ILP optimum."""
    gaps = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        for seed in (0, 1, 2):
            tensors, pack, bayes, params = small_problem(seed)
            gt = (0, 2)
            _, ilp_lik = ilp.solve_ilp(gt, tensors, pack, bayes, params)
            cfg = SolverConfig(
                anneal_steps=0, polish_steps=0,
                depth_contrib=params.depth_contrib,
                aln_contrib=params.aln_contrib, prob_diff=params.prob_diff,
                tweak=0, window_size=pack.window_size, anneal_steps_b=500,
                move_thin=0.3)
            liks, _ = SB.solve_genotypes(
                seed, np.array([gt]), tensors.hap_prob, tensors.hap_mid,
                tensors.unmapped_prob, pack.n_windows, pack.reg_start,
                pack.contig_len, pack.gc_at, pack.weight_at, bayes, cfg,
                n_attempts=8, max_windows=pack.max_windows, n_steps=1000,
                device=device)
            check(liks.device.type == device, f"batched engine ran on "
                  f"{liks.device}, asked {device}")
            best = float(liks.max())
            check(abs(best - ilp_lik) <= 0.05 and best <= ilp_lik + 0.05,
                  f"batched engine ({device}) best {best} != ILP optimum "
                  f"{ilp_lik} on problem {seed}")
            gaps[(device, seed)] = ilp_lik - best
        if device == "cuda":
            sync()
            t_card = time.perf_counter() - t0
    print(f"batched engine, 8 attempts x 1,000 super-steps: best within 0.05 "
          f"of the ILP optimum of problems 0-2 on the card (gaps "
          f"{[round(gaps[('cuda', s)], 6) for s in range(3)]}) and on the CPU "
          f"({[round(gaps[('cpu', s)], 6) for s in range(3)]}); "
          f"{t_card:.2f} s on the card", flush=True)


# -- K3 / K5 -----------------------------------------------------------------

def make_reads(seed, B, L, n_frac=0.001):
    """Random codes with a few N, one row of a single repeated base (every
    hash ties) and one row with a long run of N."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, L), dtype=np.int8)
    reads[rng.random((B, L)) < n_frac] = 4
    reads[0] = 2
    reads[-1, L // 4:L // 2] = 4
    return torch.from_numpy(reads).cuda()


def front_bound_ms(reads, k, w, S):
    B, L = reads.shape
    P = L - k + 1
    cols = P if S is None else S
    moved = B * L + B * cols * (4 + 1 + 1) + (0 if S is None else 4 * B)
    ops = B * P * (K3_OPS_FIXED + K3_OPS_PER_NEIGHBOUR * (w - 1))
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def compare_front(reads, k, w, S, what):
    """Kernel vs plain version on the card: every output bit-identical
    (integers only).  Returns a dict of measurements."""
    got = R.minimizer_front(reads, k, w, S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = R.minimizer_front_reference(reads, k, w, S)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0.0
    for name, a, b in zip(("hs", "is_fw", "mask", "total"), got, want):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"minimizer_front {what}: {name} is {a.dtype} {tuple(a.shape)}, "
              f"plain {b.dtype} {tuple(b.shape)}")
        n_bad = int((a != b).sum())
        check(n_bad == 0, f"minimizer_front {what}: {n_bad} values differ "
                          f"in {name}")
        err = max(err, float((a.to(torch.int64) - b.to(torch.int64))
                             .abs().max()))
    check(bool(got[2].any()) or reads.shape[1] - k + 1 < w,
          f"minimizer_front {what}: empty mask")
    ms = time_ms(lambda: R.minimizer_front(reads, k, w, S))
    bound_ms, bound_by = front_bound_ms(reads, k, w, S)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                bound_by=bound_by,
                shape=dict(B=int(reads.shape[0]), L=int(reads.shape[1]), k=k,
                           w=w, S=S, minimizers=int(got[2].sum())))


def phase_front():
    for B, L, S, entry in ((65536, 192, R._front_S(192 - 15 + 1, 10),
                            "compact"), (128, 16384, None, "full")):
        r = compare_front(make_reads(B + L, B, L), 15, 10, S,
                          f"{entry} {B}x{L}")
        print(f"K3/K5 minimizer_front {entry} {B} reads L={L} k=15 w=10 "
              f"S={S}: all outputs bit-identical; {r['ms']:.4f} ms/launch, "
              f"{B * L / r['ms'] * 1e3:.3e} bases/s "
              f"(plain {r['plain_ms']:.0f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']})", flush=True)
    # Other parameters, a truncating S, S past the row, one short row; the
    # edges of the kernel's schedule: fewer rows than a block of 4 warps, an
    # S cut inside a later chunk of 256 positions, rows of no multiple of
    # 16 bytes, the largest w (past 48 KB of shared memory a block); k = 16,
    # whose k-mers fill the 32-bit word.
    further = ((999, 152, 15, 10, 8), (999, 152, 11, 5, None),
               (999, 152, 7, 1, 160), (1, 15, 15, 10, 4),
               (77, 3001, 15, 40, None), (77, 3001, 13, 63, 900),
               (5, 200, 15, 10, 20), (333, 1000, 15, 10, 100),
               (129, 1001, 13, 12, 64), (9, 2000, 15, 1024, 30),
               (9, 2000, 15, 1024, None), (999, 152, 16, 10, None),
               (333, 1000, 16, 10, 100), (1, 16, 16, 10, 4))
    for B, L, k, w, S in further:
        compare_front(make_reads(B + L + w, B, L, 0.01), k, w, S,
                      f"{B}x{L} k={k} w={w} S={S}")
    empty = torch.empty((0, 192), dtype=torch.int8, device="cuda")
    for S in (None, 80):
        for a, b in zip(R.minimizer_front(empty, 15, 10, S),
                        R.minimizer_front_reference(empty, 15, 10, S)):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"minimizer_front empty batch S={S}: {a.dtype} "
                  f"{tuple(a.shape)}, plain {b.dtype} {tuple(b.shape)}")
    print(f"K3/K5 minimizer_front {len(further)} further shapes and "
          "parameters and an empty batch: all outputs bit-identical",
          flush=True)


# -- main path ---------------------------------------------------------------

def make_bg(read_len=150.0, depth_per_hap=DEPTH, window=100):
    """Background distributions matching the simulator's settings."""
    err = ErrorProfile.estimate(997600, 2000, 200, 200,
                                [(0, 150, 100.0), (1, 150, 50.0)])
    ins = InsertDistr.from_nbinom(NBinom.estimate(400.0, 4000.0))
    hap_m = depth_per_hap * window / (2 * read_len) / 2.0
    depth = ReadDepth(2, window, 300,
                      [NBinom.estimate(hap_m, hap_m * 1.6)] * 101)
    return BgDistr(SequencingInfo(read_len, Technology.ILLUMINA), ins, err,
                   depth)


def make_bg_long(depth=10.0, window=2000):
    """Background distributions of the long-read sample (ONT-like)."""
    err = ErrorProfile.estimate(950000, 20000, 8000, 8000,
                                [(420, 12000, 50.0), (470, 12000, 30.0)])
    m = depth * window / 12000.0 / 2.0
    return BgDistr(SequencingInfo(12000.0, Technology.NANOPORE),
                   InsertDistr.undefined(), err,
                   ReadDepth(2, window, max(window, 300),
                             [NBinom.estimate(m, m * 1.5)] * 101))


def build_genome(loci, rng, flank_len):
    """Genome with one copy of every locus between random flanks, and the
    loci's k-mer counts against it."""
    flanks = [sim.random_genome(rng, flank_len) for _ in range(len(loci) + 1)]
    genome = np.concatenate(
        [p for pair in zip(flanks, [lc.haplotypes[0] for lc in loci])
         for p in pair] + [flanks[-1]])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    data = {}
    for locus in loci:
        kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
        data[locus.name] = LocusData(
            ContigSet(locus.name, locus.hap_names, locus.haplotypes), kc)
    return genome, flanks, data


def build_sample(loci, rng, background_multiple):
    """Paired short reads: the true genotypes' reads plus off-locus
    background.  Returns (genome, data, (names, reads1, reads2))."""
    genome, flanks, data = build_genome(loci, rng, 20000)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    pools = [sim.simulate_paired_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=DEPTH,
        read_len=150, errors=err, prefix=locus.name) for locus in loci]
    pools.append(sim.simulate_paired_reads(
        rng, flanks * background_multiple, depth=DEPTH, read_len=150,
        errors=err, prefix="bg"))
    names = [n for p in pools for n in p.names]
    reads1 = [r for p in pools for r in p.reads1]
    reads2 = [r for p in pools for r in p.reads2]
    return genome, data, (names, reads1, reads2)


def build_long_sample(loci, rng, depth=10.0):
    """Long single reads of 12,000 +- 2,000 bases: the true genotypes at
    `depth`, the flanks at half of it.  Returns (data, (names, reads))."""
    _, flanks, data = build_genome(loci, rng, 30000)
    err = sim.ErrorModel(mismatch=0.02, insertion=0.008, deletion=0.008)
    pools = [sim.simulate_single_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=depth,
        read_len_mean=12000, read_len_sd=2000, errors=err, prefix=locus.name)
        for locus in loci]
    pools.append(sim.simulate_single_reads(
        rng, flanks, depth=depth / 2, read_len_mean=12000, read_len_sd=2000,
        errors=err, prefix="bg"))
    return data, ([n for p in pools for n in p.names],
                  [r for p in pools for r in p.reads1])


def write_fastq_pair(tmp, names, reads1, reads2):
    fq1, fq2 = tmp / "reads_1.fq.gz", tmp / "reads_2.fq.gz"
    with gzip.open(fq1, "wt", compresslevel=1) as f1, \
            gzip.open(fq2, "wt", compresslevel=1) as f2:
        for n, a, b in zip(names, reads1, reads2):
            fastx.write_fastq(f1, fastx.Read(n, a))
            fastx.write_fastq(f2, fastx.Read(n, b))
    return fq1, fq2


def run_main_path(what, loci, data, n_reads, recruit, bg, band, seed,
                  mesh=None, keep=None):
    """recruit -> align -> solve, all on the GPU, default scheme; alignment
    and solving split over `mesh`'s shards when one is given.  `recruit()`
    returns {locus: (read_pairs, names)}; returns the same.  `keep`, a
    dict, receives the alignments ("built")."""
    tech = bg.seq_info.technology
    params = Params(unmapped_penalty=tech.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    params.band = band
    cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = recruit()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    panel = [(rec[lc.name][0], rec[lc.name][1], data[lc.name].contig_set,
              data[lc.name].kmer_counts) for lc in loci]
    built = build_all_alignments_panel(panel, bg, cache, params, mesh=mesh)
    if keep is not None:
        keep["built"] = built
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    entries = [dict(locus=data[lc.name], read_pairs=rec[lc.name][0],
                    names=rec[lc.name][1], tag=lc.name, prebuilt=built[i])
               for i, lc in enumerate(loci)]
    solved = genotype_panel(entries, bg, params=params,
                            scheme=Scheme.default(), seed=seed, mesh=mesh)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n_exact = 0
    for (res, _), locus in zip(solved, loci):
        call = tuple(sorted(int(h) for h in res.genotypes[0]))
        truth = tuple(sorted(locus.true_genotype))
        check(call == truth, f"{what} {locus.name}: called {call}, "
                             f"truth {truth}")
        check(np.isfinite(res.predictions[0].lik_mean)
              and np.isfinite(res.quality), f"{what}: non-finite result")
        n_exact += 1
    n_haps = len(loci[0].haplotypes)
    shapes = [[n_haps * (n_haps + 1) // 2, built[i][0].n_used, 2 * 10 + 1]
              for i in range(len(loci))]
    print(f"main path {what}: {n_reads} reads or pairs, "
          f"{sum(len(rec[lc.name][0]) for lc in loci)} recruited, "
          f"{n_exact}/{len(loci)} calls equal the truth; "
          f"recruit {t1 - t0:.2f} s, align {t2 - t1:.2f} s, "
          f"solve {t3 - t2:.2f} s; [G, R, K] per locus {shapes}; "
          f"launches {dict(_kernels.LAUNCHES)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB", flush=True)
    return rec


def check_against_host(what, data, rec, read_iter, rp, ordered=True):
    """The device recruiter's reads equal the per-read host engine's, on
    reads padded with N as a device row pads them (w - 1 codes saturate the
    effect); the count that the padding moves is printed."""
    reads = list(read_iter)
    host = host_recruit_reads(data, iter(reads), rp, pad=rp.minimizer_w - 1)
    bare = host_recruit_reads(data, iter(reads), rp)
    moved = 0
    for name in data:
        got, want = rec[name][1], host[name][1]
        if not ordered:
            got, want = sorted(got), sorted(want)
        check(got == want, f"{what} {name}: device recruited {len(got)} "
                           f"reads, host engine {len(want)}; "
                           f"{len(set(got) ^ set(want))} names differ")
        check(len(got) > 0, f"{what} {name}: nothing recruited")
        moved += len(set(bare[name][1]) ^ set(want))
    print(f"recruit {what}: device reads equal the host engine's at all "
          f"{len(data)} loci ({sum(len(rec[n][1]) for n in data)} reads); "
          f"row padding moves {moved} of them", flush=True)


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def write_locus_files(what, tmp, loci, genome, starts):
    """ref.fa with one contig `chr1`, loci.bed and haps_<locus>.fa for
    `add`; the loci's first haplotypes sit in `genome` at `starts`."""
    ref, bed = tmp / "ref.fa", tmp / "loci.bed"
    with open(ref, "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    rows = []
    for lc, pos in zip(loci, starts):
        end = pos + lc.haplotypes[0].size
        rows.append(f"chr1\t{pos}\t{end}\t{lc.name}")
        check(np.array_equal(genome[pos:end], lc.haplotypes[0]),
              f"{what}: locus not at {pos}")
        with open(tmp / f"haps_{lc.name}.fa", "w") as f:
            for name, seq in zip(lc.hap_names, lc.haplotypes):
                fastx.write_fasta(f, name, seq)
    bed.write_text("\n".join(rows) + "\n")
    return ref, bed


def check_calls(what, out, loci):
    """Every res.json.gz names the truth; returns the results by locus."""
    results = {}
    for lc in loci:
        with gzip.open(paths.locus_dir(out, lc.name) / paths.RES_JSON,
                       "rt") as f:
            res = json.load(f)
        truth = sorted(lc.hap_names[i] for i in lc.true_genotype)
        check(sorted(res["genotype"].split(",")) == truth,
              f"{what} {lc.name}: called {res['genotype']}, truth {truth}")
        check(np.isfinite(res["quality"]), f"{what}: non-finite quality")
        results[lc.name] = res
    return results


def bam_and_sam(what, bam_path, sam_path):
    """The records of a BAM (read with the port's seq/bam.py, unmapped and
    secondary ones too) and the body of its SAM.gz twin, which must agree
    on name, flag and position record for record."""
    check(bam_path.exists() and sam_path.exists(),
          f"{what}: {bam_path.name} or {sam_path.name} missing")
    recs = list(tbam.read_bam_records(bam_path, keep_flags=0))
    with gzip.open(sam_path, "rt") as f:
        body = [line.split("\t") for line in f if not line.startswith("@")]
    check([(r.name, r.flag, r.pos) for r in recs]
          == [(b[0], int(b[1]), int(b[3]) - 1) for b in body],
          f"{what}: {bam_path.name} and {sam_path.name} differ")
    return recs


def check_alignment_files(what, out, loci, results, map_out):
    """`--out-bams 1 --out-sams 1`: alns/00.bam and alns/00.sam.gz hold one
    record per mapped mate of every modeled read under the best genotype
    (one unmapped record where the read went to no haplotype);
    `--stop-after map`: aln.bam and aln.sam.gz hold every candidate
    alignment of the same reads.  Returns the record counts."""
    n_best = n_all = 0
    for lc in loci:
        alns = paths.locus_dir(out, lc.name) / paths.ALNS_OUT_DIR
        recs = bam_and_sam(f"{what} {lc.name}", alns / "00.bam",
                           alns / "00.sam.gz")
        per_read = {}
        for r in recs:
            per_read.setdefault(r.name, []).append(r)
        check(len(per_read) == results[lc.name]["total_reads"],
              f"{what} {lc.name}: {len(per_read)} reads in 00.bam, "
              f"{results[lc.name]['total_reads']} modeled")
        for name, mates in per_read.items():
            mapped = [r for r in mates if not r.flag & tbam.FLAG_UNMAPPED]
            check(len(mates) == 1 if len(mapped) < len(mates)
                  else sorted(r.mate_ix for r in mates) in ([0], [1], [0, 1]),
                  f"{what} {lc.name}: read {name} has records "
                  f"{[r.flag for r in mates]}")
        ldir = paths.locus_dir(map_out, lc.name)
        all_recs = bam_and_sam(f"{what} {lc.name} map", ldir / "aln.bam",
                               ldir / "aln.sam.gz")
        check({r.name for r in all_recs} <= set(per_read)
              and len(all_recs) >= len(recs) - sum(
                  bool(r.flag & tbam.FLAG_UNMAPPED) for r in recs),
              f"{what} {lc.name}: aln.bam holds reads or records that the "
              "model does not")
        n_best += len(recs)
        n_all += len(all_recs)
    return n_best, n_all


def locus_starts(genome, loci):
    """Where `build_genome` put the loci's first haplotypes: between flanks
    of one length."""
    pos, starts = 0, []
    flank = (genome.size - sum(lc.haplotypes[0].size for lc in loci)) \
        // (len(loci) + 1)
    for lc in loci:
        pos += flank
        starts.append(pos)
        pos += lc.haplotypes[0].size
    return starts


def run_cli_path(what, tmp, loci, genome, fq1, fq2, device_args=()):
    """`add` then `genotype` through the command line, FASTQ to
    res.json.gz and the best genotype's BAM and SAM files, on the default
    device (CUDA); then `genotype --stop-after map`."""
    ref, bed = write_locus_files(what, tmp, loci, genome,
                                 locus_starts(genome, loci))
    db, prep, out = tmp / "db", tmp / "sample", tmp / "out"
    t0 = time.perf_counter()
    rc = cli.main([*device_args, "add", "-d", str(db), "-r", str(ref),
                   "-l", str(bed), "-s", str(tmp / "haps_{}.fa")])
    check(rc == 0, f"{what}: add returned {rc}")
    paths.bg_dir(prep).mkdir(parents=True)
    make_bg().save(paths.bg_dir(prep) / paths.BG_DISTR)
    t1 = time.perf_counter()
    reads = ["-i", str(fq1), str(fq2), "-d", str(db), "-p", str(prep)]
    rc = cli.main([*device_args, "genotype", *reads, "-o", str(out),
                   "--seed", "1", "--out-bams", "1", "--out-sams", "1"])
    sync()
    t2 = time.perf_counter()
    check(rc == 0, f"{what}: genotype returned {rc}")
    results = check_calls(what, out, loci)
    rc = cli.main([*device_args, "genotype", *reads, "-o",
                   str(tmp / "out_map"), "--stop-after", "map"])
    sync()
    t3 = time.perf_counter()
    check(rc == 0, f"{what}: genotype --stop-after map returned {rc}")
    n_best, n_all = check_alignment_files(what, out, loci, results,
                                          tmp / "out_map")
    print(f"main path {what}: add {t1 - t0:.2f} s, genotype (FASTQ to "
          f"res.json.gz, 00.bam, 00.sam.gz) {t2 - t1:.2f} s, "
          f"{len(loci)}/{len(loci)} res.json.gz name the truth, {n_best} "
          f"records under the calls; --stop-after map {t3 - t2:.2f} s, "
          f"{n_all} records in aln.bam; launches "
          f"{dict(_kernels.LAUNCHES)}", flush=True)


def run_genotype_cli(what, tmp, loci, fq1, fq2, out_name, extra=(),
                     device_args=()):
    """`genotype` on (a')'s files, database and background into
    `out_name`; every call must equal the truth and (a')'s call.  Returns
    the seconds and the captured log."""
    db, prep, out = tmp / "db", tmp / "sample", tmp / out_name
    with LogLines() as log:
        t0 = time.perf_counter()
        rc = cli.main([*device_args, "genotype", "-i", str(fq1), str(fq2),
                       "-d", str(db),
                       "-p", str(prep), "-o", str(out), "--seed", "1",
                       *extra])
        sync()
        secs = time.perf_counter() - t0
    check(rc == 0, f"{what}: genotype returned {rc}")
    results = check_calls(what, out, loci)
    chains = check_calls(f"{what}, (a')", tmp / "out", loci)
    for lc in loci:
        check(sorted(results[lc.name]["genotype"].split(","))
              == sorted(chains[lc.name]["genotype"].split(",")),
              f"{what} {lc.name}: called {results[lc.name]['genotype']}, "
              f"(a') {chains[lc.name]['genotype']}")
    return secs, log


def stage_seconds(log):
    """The seconds of solver stages 1 and 2 from a `genotype` log."""
    return [log.find(rf"Stage {i} \((?:greedy|anneal)\):.* in ([\d.]+)s")
            for i in (1, 2)]


def run_seq_cli(what, tmp, loci, fq1, fq2, greedy_iters, device_args=()):
    """(a-seq): (a')'s files, database and background through `genotype`
    under the sequential engine; every call must equal the truth and the
    chains engine's call in (a')'s res.json.gz.  `greedy_iters` receives
    the iterations of every greedy chain."""
    secs, log = run_genotype_cli(what, tmp, loci, fq1, fq2, "out_seq",
                                 ["-S", *SEQ_SCHEME], device_args)
    stages = stage_seconds(log)
    check(all(stages), f"{what}: no stage times in the log")
    check(greedy_iters, f"{what}: no greedy chain ran")
    iters = torch.cat([t.cpu() for t in greedy_iters]).double()
    print(f"main path {what}: genotype (FASTQ to res.json.gz) "
          f"{secs:.2f} s, solve stage 1 (greedy) {stages[0]} s, stage 2 "
          f"(anneal) {stages[1]} s; greedy iterations to plateau mean "
          f"{float(iters.mean()):.1f}, max {int(iters.max())} over "
          f"{iters.numel()} chains; {len(loci)}/{len(loci)} res.json.gz name "
          f"the truth and equal the chains engine's calls; launches "
          f"{dict(_kernels.LAUNCHES)}", flush=True)


def run_mesh_cli(what, tmp, loci, fq1, fq2, grid, recruited, out_name,
                 device_args=()):
    """(a-mesh): (a')'s files through `genotype` with
    `parallel.mesh.auto_mesh` returning `grid` (the monkeypatch of the
    reference's tests/test_readwidth.py:147; restored afterwards), or the
    real `auto_mesh()` when `grid` is None.  Recruitment, alignment and
    solving are split over the grid's shards; the recruited reads must equal
    (a')'s name by name, every call the truth and (a')'s call."""
    real = M.auto_mesh
    used = []

    def patched():
        used.append(grid if grid is not None else real())
        return used[-1]

    M.auto_mesh = patched
    try:
        secs, log = run_genotype_cli(what, tmp, loci, fq1, fq2, out_name,
                                     device_args=device_args)
    finally:
        M.auto_mesh = real
    mesh = used[0] if used else None
    check(mesh is not None, f"{what}: no grid (auto_mesh gave {used})")
    n = log.find(r"Recruitment sharded over (\d+) devices")
    check(n == str(mesh.devices.size), f"{what}: recruitment sharded over "
          f"{n} devices, grid of {mesh.devices.size}")
    for lc in loci:
        got, want = recruited[out_name][lc.name], recruited["out"][lc.name]
        check(got == want, f"{what} {lc.name}: {len(got)} reads recruited, "
              f"(a') {len(want)}; {len(set(got) ^ set(want))} names differ")
    stages = stage_seconds(log)
    print(f"main path {what}: grid {mesh}; genotype (FASTQ to res.json.gz) "
          f"{secs:.2f} s, solve stages {stages[0]} / {stages[1]} s; "
          f"recruited reads equal (a')'s name by name "
          f"({sum(len(v) for v in recruited[out_name].values())}); "
          f"{len(loci)}/{len(loci)} res.json.gz name the truth and equal "
          f"(a')'s calls; launches {dict(_kernels.LAUNCHES)}", flush=True)


def run_batched_cli(what, tmp, loci, fq1, fq2, device_args=()):
    """(a-batched): (a')'s files through `genotype -S ...,e=batched`: the
    batched-move engine (plain PyTorch on the card, no kernel of its own);
    every call must equal the truth and (a')'s call."""
    secs, log = run_genotype_cli(what, tmp, loci, fq1, fq2, "out_batched",
                                 ["-S", *BATCHED_SCHEME], device_args)
    stages = stage_seconds(log)
    check(all(stages), f"{what}: no stage times in the log")
    print(f"main path {what}: genotype (FASTQ to res.json.gz) {secs:.2f} s, "
          f"solve stage 1 (greedy, 400 super-steps) {stages[0]} s, stage 2 "
          f"(anneal, 1,000 super-steps) {stages[1]} s; {len(loci)}/"
          f"{len(loci)} res.json.gz name the truth and equal (a')'s calls; "
          f"launches {dict(_kernels.LAUNCHES)}", flush=True)


class MeshCapture:
    """While in use, keeps what (b-mesh) hands the grid: the job arrays of
    every alignment dispatch and the first genotype-sharded stage chunk
    (its runner, seed, genotypes and outputs), for `check_b_mesh`."""

    def __enter__(self):
        self.jobs, self.chunk = [], None
        self._dispatch = LC.dispatch_align_batches
        self._stage = M.sharded_stage_solver

        def dispatch(*args, **kw):
            self.jobs.append(args[:5])
            return self._dispatch(*args, **kw)

        def stage(mesh, run_solver, seed, gts):
            out = self._stage(mesh, run_solver, seed, gts)
            if self.chunk is None:
                self.chunk = (run_solver, seed, np.asarray(gts), out)
            return out

        LC.dispatch_align_batches, M.sharded_stage_solver = dispatch, stage
        return self

    def __exit__(self, *exc):
        LC.dispatch_align_batches = self._dispatch
        M.sharded_stage_solver = self._stage


def synthetic_problem(n_reads, n_haps=4, hap_len=2000, kh=4, seed=0):
    """`__graft_entry__._synthetic_problem` with the port's classes: random
    locus tensors, all genotypes, 50 + 50 steps."""
    rng = np.random.default_rng(seed)
    hap_prob = rng.normal(-3.0, 2.0, (n_haps, n_reads, kh)).astype(np.float32)
    hap_prob[rng.random((n_haps, n_reads, kh)) < 0.4] = -1e30
    hap_mid = rng.integers(0, hap_len, (n_haps, n_reads, kh, 2)) \
        .astype(np.int32)
    hap_mid[rng.random((n_haps, n_reads, kh, 2)) < 0.1] = -1
    window, boundary = 100, 200
    n_win = (hap_len - 2 * boundary) // window
    tensors = LocusTensors(hap_prob, hap_mid,
                           np.full(n_reads, -40.0, np.float32), n_haps,
                           n_reads, kh)
    pack = ContigInfoPack(
        n_haps=n_haps, max_len=hap_len, max_windows=n_win,
        n_windows=np.full(n_haps, n_win, np.int32),
        reg_start=np.full(n_haps, (hap_len - n_win * window) // 2, np.int32),
        contig_len=np.full(n_haps, hap_len, np.int32), window_size=window,
        gc_at=rng.integers(30, 70, (n_haps, hap_len)).astype(np.int32),
        weight_at=rng.uniform(0.5, 1.0, (n_haps, hap_len)).astype(np.float32))
    bayes = build_bayes_table([NBinom(3.0, 0.4)] * 101, [0.3, 2.0, 3.0], 2.0)
    gts = np.array([(a, b) for a in range(n_haps) for b in range(a, n_haps)],
                   np.int32)
    cfg = SolverConfig(anneal_steps=50, polish_steps=50, tweak=50,
                       window_size=window)
    return tensors, pack, bayes, gts, cfg


def check_b_mesh(what, grid, cap, built, device="cuda"):
    """(b-mesh)'s comparisons, after its launches were counted:
    `sharded_align` on its whole job set equals the one-device
    `dispatch_align_batches` to the bit; the read-sharded stage-0 scores are
    within a relative 1e-5 of the host's and select the same genotypes;
    each shard of the first stage chunk equals one call of the annealer on
    that shard's rows with that shard's seed, to the bit.  Then
    `parallel.mesh.full_step` (the multi-device dry run) on the grid."""
    t0 = time.perf_counter()
    check(cap.jobs, f"{what}: no alignment dispatch")
    n_jobs = 0
    for reads, lens, wins, sv, band in cap.jobs:
        got = M.sharded_align(grid, reads, lens, wins, sv, band)
        want = LC.collect_align_batches(LC.dispatch_align_batches(
            reads, lens, wins, sv, band, device=device))
        for k in want:
            check(np.array_equal(got[k], want[k]),
                  f"{what}: sharded_align {k} differs from one device")
        n_jobs += reads.shape[0]
    t1 = time.perf_counter()

    all_alns = built[0][0]
    tensors = LocusTensors.build(all_alns)
    n_haps = tensors.n_haps
    gts = np.array([(a, b) for a in range(n_haps) for b in range(a, n_haps)],
                   np.int32)
    priors = np.zeros(gts.shape[0])
    n_real = tensors.n_reads
    best_aln = np.maximum(tensors.hap_prob[:, :n_real].max(axis=2),
                          tensors.unmapped_prob[None, :n_real])
    gt_best = np.maximum(best_aln[gts[:, 0]], best_aln[gts[:, 1]])
    host = priors + gt_best.sum(axis=1)
    pad_r = (-n_real) % grid.shape["read"]
    sharded = M.sharded_filter_scores(
        grid, np.pad(best_aln, ((0, 0), (0, pad_r))), gts,
        priors.astype(np.float32))
    rel = float(np.max(np.abs(sharded - host) / np.abs(host)))
    check(rel <= 1e-5, f"{what}: stage-0 scores differ by {rel} relative")
    params = Params()
    keep_host = run_filter(gts, priors, best_aln, params.filt_diff, 5000)
    keep_grid = select_by_scores(sharded.astype(np.float64),
                                 params.filt_diff, 5000)
    check(set(keep_host.tolist()) == set(keep_grid.tolist()),
          f"{what}: the filter keeps {keep_grid.size} genotypes on the grid, "
          f"{keep_host.size} on the host, "
          f"{len(set(keep_host.tolist()) ^ set(keep_grid.tolist()))} differ")
    t2 = time.perf_counter()

    check(cap.chunk is not None, f"{what}: no genotype-sharded stage chunk")
    run_solver, seed, chunk_gts, (liks, assgns) = cap.chunk
    per, pad = M.shard_rows(grid, chunk_gts.shape[0])
    padded = np.concatenate([chunk_gts, np.repeat(chunk_gts[-1:], pad, 0)])
    G = chunk_gts.shape[0]
    for ix, dev in enumerate(grid.shards):
        lo, hi = ix * per, min((ix + 1) * per, G)
        one_l, one_a = run_solver(derive_seed(seed, "shard", ix),
                                  padded[ix * per:(ix + 1) * per], dev)
        check(torch.equal(liks[lo:hi], one_l[:hi - lo].to(liks.device))
              and torch.equal(assgns[lo:hi],
                              one_a[:hi - lo].to(assgns.device)),
              f"{what}: shard {ix} of the first stage chunk differs from "
              "its one-device launch")
    t3 = time.perf_counter()

    st, pk, bayes, sgts, cfg = synthetic_problem(8 * grid.devices.size)
    scores, fliks = M.full_step(grid, 0, st, pk, bayes, sgts,
                                np.zeros(sgts.shape[0]), cfg, n_attempts=2)
    one, _ = SQ.solve_genotypes(
        0, sgts, st.hap_prob, st.hap_mid, st.unmapped_prob, pk.n_windows,
        pk.reg_start, pk.contig_len, pk.gc_at, pk.weight_at, bayes, cfg,
        n_attempts=2, max_windows=pk.max_windows, device=device)
    sb = np.maximum(st.hap_prob.max(axis=2), st.unmapped_prob[None, :])
    want_scores = np.maximum(sb[sgts[:, 0]], sb[sgts[:, 1]]).sum(axis=1)
    check(np.allclose(scores, want_scores, rtol=1e-5, atol=0)
          and np.array_equal(fliks, one.cpu().numpy())
          and np.isfinite(fliks).all(),
          f"{what}: full_step differs from one device")
    print(f"{what} checks: sharded_align on all {n_jobs} jobs equals one "
          f"device on every output ({t1 - t0:.2f} s); stage-0 scores of "
          f"{gts.shape[0]} genotypes within {rel:.1e} relative of the host's, "
          f"the same {keep_grid.size} kept ({t2 - t1:.2f} s); every shard of "
          f"the first stage chunk ({G} genotypes, {per} a shard) equals its "
          f"one-device launch ({t3 - t2:.2f} s); full_step on "
          f"{sgts.shape[0]} genotypes equals one device", flush=True)


def build_100k_sample(rng, locus_len=BIG_LOCUS, flank=50_000,
                      long_reads=(84_000, 6_000), read_len=(20_000, 5_000),
                      window=2000):
    """extra/validate_stream_100k.py's case with the port's sim.py: one
    locus of `locus_len` (4 haplotypes, 1 % divergence) between random
    flanks, ONT-like reads of the true genotype at 8x plus reads of
    `long_reads` (mean, sd) at 5x, 4x of background from the left flank.
    Returns (locus, data, names, reads, bg, rp)."""
    locus = sim.simulate_locus(rng, "BIG", length=locus_len, n_haps=4,
                               divergence=0.01)
    genome = np.concatenate([sim.random_genome(rng, flank),
                             locus.haplotypes[0],
                             sim.random_genome(rng, flank)])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
    data = {locus.name: LocusData(
        ContigSet(locus.name, locus.hap_names, locus.haplotypes), kc)}
    err = sim.ErrorModel(mismatch=0.02, insertion=0.008, deletion=0.008)
    haps = [locus.haplotypes[i] for i in locus.true_genotype]
    pools = [
        sim.simulate_single_reads(rng, haps, depth=8.0,
                                  read_len_mean=read_len[0],
                                  read_len_sd=read_len[1], errors=err,
                                  prefix="big"),
        sim.simulate_single_reads(rng, haps, depth=5.0,
                                  read_len_mean=long_reads[0],
                                  read_len_sd=long_reads[1], errors=err,
                                  prefix="long"),
        sim.simulate_single_reads(rng, [genome[:flank]], depth=4.0,
                                  read_len_mean=read_len[0],
                                  read_len_sd=read_len[1], errors=err,
                                  prefix="bg")]
    names = [n for p in pools for n in p.names]
    reads = [r for p in pools for r in p.reads1]
    # Read middles a window and haplotype, from the mixture of lengths.
    m = (8.0 * window / read_len[0] + 5.0 * window / long_reads[0]) / 2.0
    bg = BgDistr(SequencingInfo(float(read_len[0]), Technology.NANOPORE),
                 InsertDistr.undefined(),
                 ErrorProfile.estimate(950000, 20000, 8000, 8000,
                                       [(700, 20000, 50.0),
                                        (780, 20000, 30.0)]),
                 ReadDepth(2, window, max(window, 300),
                           [NBinom.estimate(m, m * 1.5)] * 101))
    rp = RecruitParams(
        match_frac=Technology.NANOPORE.default_match_frac(False),
        match_length=2000)
    return locus, data, names, reads, bg, rp


def longest_jobs(lens, longer_than, n=8):
    """Up to n jobs of one launch whose reads are longer than
    `longer_than`, the shortest such first (the plain aligner walks as
    many rows as the longest read it is given)."""
    over = torch.nonzero(lens > longer_than)[:, 0]
    return over[torch.argsort(lens[over], stable=True)[:n]]


# -- (d): a WGS-like sample through add, preproc and genotype ----------------

def sample_pairs(rng, copies, depth, sub_rate, read_len=150,
                 insert_mean=400.0, insert_sd=60.0):
    """Paired reads drawn uniformly from each sequence of `copies` at
    `depth` (per copy): fragment lengths N(insert_mean, insert_sd), mate 1
    from the fragment's start, mate 2 the reverse complement of its end, the
    mates swapped in half of the pairs, substitutions at `sub_rate`.  One
    gather per copy.  Returns ([N, read_len] int8, the same, frags) in a
    random order; `frags` holds [N] arrays of where each pair was drawn:
    `copy` (its index in `copies`), `start` and `ins` (the fragment) and
    `swap` (mate 1 is the reverse complement of the fragment's end)."""
    firsts, seconds, frags = [], [], []
    ar = np.arange(read_len)
    for c, seq in enumerate(copies):
        n = int(depth * seq.size / (2 * read_len) + 0.5)
        ins = np.clip(np.rint(rng.normal(insert_mean, insert_sd, n)),
                      read_len, seq.size).astype(np.int64)
        start = (rng.random(n) * (seq.size - ins + 1)).astype(np.int64)
        m1 = seq[start[:, None] + ar]
        m2 = 3 - seq[(start + ins - read_len)[:, None] + ar][:, ::-1]
        swap = rng.random(n) < 0.5
        m1[swap], m2[swap] = m2[swap], m1[swap]
        for m in (m1, m2):
            sub = rng.random(m.shape, dtype=np.float32) < sub_rate
            m[sub] = (m[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        firsts.append(m1)
        seconds.append(m2)
        frags.append((np.full(n, c), start, ins, swap))
    order = rng.permutation(sum(m.shape[0] for m in firsts))
    return (np.concatenate(firsts)[order], np.concatenate(seconds)[order],
            {key: np.concatenate([f[i] for f in frags])[order]
             for i, key in enumerate(("copy", "start", "ins", "swap"))})


def write_fastq_arrays(path, reads, prefix, mode="wb"):
    """One gzip FASTQ of equal-length reads, written as one byte array:
    names `<prefix><index, 8 digits>`, qualities `I`.  `mode="ab"` appends
    them to `path` as another gzip member."""
    n, L = reads.shape
    digits = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    name = np.concatenate([np.full((n, 1), ord("@")),
                           np.frombuffer(prefix.encode(), np.uint8)[None, :]
                           .repeat(n, 0), digits + ord("0"),
                           np.full((n, 1), ord("\n"))], 1)
    seq = np.frombuffer(b"ACGTN", np.uint8)[reads]
    plus = np.frombuffer(b"\n+\n", np.uint8)[None, :].repeat(n, 0)
    qual = np.full((n, L), ord("I"))
    rec = np.concatenate([name, seq, plus, qual, np.full((n, 1), ord("\n"))],
                         1).astype(np.uint8)
    with gzip.open(path, mode, compresslevel=1) as f:
        f.write(rec.tobytes())


def check_wgs_estimates(what, bg):
    """`preproc`'s estimates of (d)'s sample near the simulated values;
    returns (insert mean, depth, mismatch rate)."""
    insert = bg.insert_distr.distr.mean()
    d = bg.depth.depth_distribution(41)
    depth = d.mean() * 2 * 2 * 150.0 / bg.depth.window_size
    mism = float(np.exp(bg.err_prof.ln_mismatch))
    check(abs(insert / 400.0 - 1) <= 0.05,
          f"{what}: estimated insert mean {insert:.1f}, simulated 400")
    check(abs(depth / (2 * WGS_DEPTH) - 1) <= 0.25,
          f"{what}: estimated depth {depth:.2f}x, simulated "
          f"{2 * WGS_DEPTH}x")
    check(0.5 <= mism / WGS_SUB_RATE <= 2.0,
          f"{what}: estimated mismatch rate {mism:.5f}, simulated "
          f"{WGS_SUB_RATE}")
    return insert, depth, mism


def run_wgs_path(what, tmp, loci, rng, contig_len=WGS_CONTIG,
                 locus_gap=WGS_LOCUS_GAP, device_args=()):
    """`add`, `preproc` and `genotype` through the command line on a
    WGS-like sample: one contig of `contig_len` bases of varying GC with
    the loci in its first 2 Mb, outside the central background region that
    `preproc` picks; reads from two copies of it, each carrying one
    haplotype of the true genotype at each locus, at WGS_DEPTH a copy."""
    t0 = time.perf_counter()
    genome = sim.random_genome_gc(rng, contig_len)
    starts = [locus_gap * (i + 1) for i in range(len(loci))]
    for lc, pos in zip(loci, starts):
        genome[pos:pos + lc.haplotypes[0].size] = lc.haplotypes[0]
    copies, layouts = [], []
    for c in range(2):
        parts, places, prev = [], [], 0
        for lc, pos in zip(loci, starts):
            parts += [genome[prev:pos], lc.haplotypes[lc.true_genotype[c]]]
            places += [(prev, pos - prev, False),
                       (pos, lc.haplotypes[0].size, True)]
            prev = pos + lc.haplotypes[0].size
        parts.append(genome[prev:])
        places.append((prev, genome.size - prev, False))
        copies.append(np.concatenate(parts))
        layouts.append(CopyLayout(
            np.cumsum([0] + [p.size for p in parts[:-1]]),
            *map(np.array, zip(*places))))
    reads1, reads2, frags = sample_pairs(rng, copies, WGS_DEPTH,
                                         WGS_SUB_RATE)
    t1 = time.perf_counter()
    fq1, fq2 = tmp / "wgs_1.fq.gz", tmp / "wgs_2.fq.gz"
    write_fastq_arrays(fq1, reads1, "w")
    write_fastq_arrays(fq2, reads2, "w")
    ref, bed = write_locus_files(what, tmp, loci, genome, starts)
    t2 = time.perf_counter()
    print(f"sample {what}: {contig_len:,} bases, {reads1.shape[0]} pairs "
          f"sampled in {t1 - t0:.1f} s, written to {fq1.name}, {fq2.name} "
          f"in {t2 - t1:.1f} s", flush=True)
    db, prep, out = tmp / "db", tmp / "sample", tmp / "out"
    rc = cli.main([*device_args, "add", "-d", str(db), "-r", str(ref),
                   "-l", str(bed), "-s", str(tmp / "haps_{}.fa")])
    check(rc == 0, f"{what}: add returned {rc}")
    t3 = time.perf_counter()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    preproc = [*device_args, "preproc", "-i", str(fq1), str(fq2), "-r",
               str(ref), "-o", str(prep)]
    with LogLines() as log:
        rc = cli.main(preproc)
    sync()
    t4 = time.perf_counter()
    check(rc == 0, f"{what}: preproc returned {rc}")
    region = log.find(r"Background region: (\S+)")
    n_keys = log.find(r"Recruitment index: (\d+) minimizers")
    recruited = int(log.find(r"Recruited (\d+) read pairs"))
    estimated = int(log.find(r"Subsampled to (\d+) reads for estimation")
                    or recruited)
    # preproc's legs from its log: reference, k-mer counts and the
    # region's index; recruitment; estimation (candidates, K1, counting).
    marks = [t3] + [log.when(m) for m in ("Recruitment index", "Recruited",
                                          "Preprocessing done")]
    legs = " / ".join(f"{b - a:.2f}" for a, b in zip(marks, marks[1:]))
    bg = BgDistr.load(paths.bg_dir(prep) / paths.BG_DISTR)
    insert, depth, mism = check_wgs_estimates(what, bg)
    check(bg.seq_info.total_reads == reads1.shape[0],
          f"{what}: preproc counted {bg.seq_info.total_reads} pairs")
    rc = cli.main([*device_args, "genotype", "-i", str(fq1), str(fq2),
                   "-d", str(db), "-p", str(prep), "-o", str(out),
                   "--seed", "1"])
    sync()
    t5 = time.perf_counter()
    check(rc == 0, f"{what}: genotype returned {rc}")
    check_calls(what, out, loci)
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if torch.cuda.is_available() else float("nan"))
    print(f"main path {what}: add {t3 - t2:.2f} s, preproc {t4 - t3:.2f} s "
          f"(reference, k-mer counts and index / recruitment / estimation "
          f"{legs} s; background {region}, its index {n_keys} keys, "
          f"{recruited} pairs recruited, "
          f"{estimated} estimated from; insert {insert:.1f}, depth "
          f"{depth:.2f}x, "
          f"mismatches {100 * mism:.4f} %), genotype {t5 - t4:.2f} s, "
          f"{len(loci)}/{len(loci)} res.json.gz name the truth; peak device "
          f"memory {peak:.0f} MiB; launches {dict(_kernels.LAUNCHES)}",
          flush=True)
    return dict(preproc=preproc + ["--rerun", "all"], loci=loci,
                genome=genome, layouts=layouts, reads=(reads1, reads2),
                frags=frags, ref=ref, db=db)


# -- (j): (d)'s sample as an indexed CRAM and BAM ----------------------------

class CopyLayout(namedtuple("CopyLayout", "copy_start genome_start genome_len "
                                          "is_locus")):
    """The parts of one sample copy of (d): where each part starts in the
    copy and on the contig, how long it is on the contig, and whether it is
    a locus (the copy holds a haplotype there, the contig the first)."""

    def part(self, x):
        return np.searchsorted(self.copy_start, x, side="right") - 1

    def to_genome(self, x):
        """Contig positions of copy positions `x`; inside a locus, the
        offset in the haplotype, cut at the locus's end."""
        i = self.part(x)
        return self.genome_start[i] + np.minimum(x - self.copy_start[i],
                                                 self.genome_len[i] - 1)


def aligned_records(wgs, unplaced_every=UNPLACED_EVERY):
    """(d)'s pairs as an aligner leaves them: each mate at its place on the
    contig (a pair of a locus at the locus's start plus its offset in the
    haplotype), the fragment's reverse end with flag 0x10 and its bases in
    contig orientation; one in `unplaced_every` pairs of the loci unmapped
    (flag 0x4, no position).  Returns (the placed mates as rows (pair,
    mate) sorted by position, the unplaced pairs, flags [N, 2], positions
    [N, 2], -1 where unplaced)."""
    frags = wgs["frags"]
    n = frags["start"].size
    read_len = wgs["reads"][0].shape[1]
    fwd = np.empty(n, np.int64)
    rev = np.empty(n, np.int64)
    at_locus = np.empty(n, bool)
    for c, layout in enumerate(wgs["layouts"]):
        sel = frags["copy"] == c
        start, ins = frags["start"][sel], frags["ins"][sel]
        fwd[sel] = layout.to_genome(start)
        rev[sel] = layout.to_genome(start + ins - read_len)
        at_locus[sel] = (layout.is_locus[layout.part(start)]
                         | layout.is_locus[layout.part(start + ins - 1)])
    swap = frags["swap"]
    pos = np.stack([np.where(swap, rev, fwd), np.where(swap, fwd, rev)], 1)
    flags = np.full((n, 2), tbam.FLAG_PAIRED, np.int64)
    flags[:, 0] |= tbam.FLAG_MATE1
    flags[:, 1] |= tbam.FLAG_MATE2
    flags[swap, 0] |= tbam.FLAG_REVERSE
    flags[~swap, 1] |= tbam.FLAG_REVERSE
    unplaced = np.flatnonzero(at_locus)[::unplaced_every]
    flags[unplaced] = (flags[unplaced] & ~tbam.FLAG_REVERSE) \
        | tbam.FLAG_UNMAPPED | 0x8
    pos[unplaced] = -1
    placed = np.ones(n, bool)
    placed[unplaced] = False
    pairs = np.flatnonzero(placed)
    mates = np.concatenate([np.stack([pairs, np.zeros_like(pairs)], 1),
                            np.stack([pairs, np.ones_like(pairs)], 1)])
    order = np.argsort(pos[mates[:, 0], mates[:, 1]], kind="stable")
    return mates[order], unplaced, flags, pos


def write_aligned(what, tmp, wgs):
    """wgs.cram (against ref.fa) and wgs.bam, the same records in each,
    then indexed by the port's `index`.  Returns (paths, the unplaced pairs'
    names, seconds to write, seconds to index)."""
    t0 = time.perf_counter()
    mates, unplaced, flags, pos = aligned_records(wgs)
    genome, reads = wgs["genome"], wgs["reads"]
    cram, bam = tmp / "wgs.cram", tmp / "wgs.bam"

    def name(i):
        return f"w{i:08d}"

    with CramWriter(cram, ["chr1"], [genome.size],
                    reference={"chr1": genome}) as cw, \
            tbam.BamWriter(bam, ["chr1"], [genome.size]) as bw:
        for i, m in itertools.chain(
                mates.tolist(), ((i, m) for i in unplaced.tolist()
                                 for m in (0, 1))):
            flag, p = int(flags[i, m]), int(pos[i, m])
            codes = reads[m][i]
            if flag & tbam.FLAG_REVERSE:
                codes = (3 - codes[::-1]).astype(np.int8)
            rid = 0 if p >= 0 else -1
            cw.write(name(i), flag, codes, ref_id=rid, pos=p)
            bw.write(name(i), flag, codes, ref_id=rid, pos=p)
    t1 = time.perf_counter()
    for path in (cram, bam):
        check(cli.main(["index", str(path)]) == 0, f"{what}: index {path.name}")
    t2 = time.perf_counter()
    return (cram, bam), {name(i) for i in unplaced.tolist()}, t1 - t0, t2 - t1


def run_j_path(what, tmp, wgs, rec, rp, device_args=()):
    """(j): (d)'s sample as users hold it, a coordinate-sorted, indexed
    CRAM with its reference: `preproc -a wgs.cram -r ref.fa` on (d)'s
    background region fetches through the .crai (its estimates within
    (d)'s bounds), `genotype -i wgs.cram -r ref.fa` fetches the loci's
    padded regions and the unplaced tail (every call the truth, the reads
    the host engine's over the same fetched stream), and `genotype -i
    wgs.bam -r ref.fa --stop-after recruit` recruits the same reads."""
    (cram, bam), unplaced, t_write, t_index = write_aligned(what, tmp, wgs)
    ref, db, loci = wgs["ref"], wgs["db"], wgs["loci"]
    prep = tmp / "sample_cram"
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LogLines() as log:
        rc = cli.main([*device_args, "preproc", "-a", str(cram), "-r",
                       str(ref), "-o", str(prep)])
    sync()
    t1 = time.perf_counter()
    check(rc == 0, f"{what}: preproc returned {rc}")
    fetched = log.find(r"Indexed input: fetched (\d+) read")
    check(fetched is not None, f"{what}: preproc did not fetch by the index")
    bg = BgDistr.load(paths.bg_dir(prep) / paths.BG_DISTR)
    insert, depth, mism = check_wgs_estimates(what, bg)
    with LogLines() as log:
        rc = cli.main([*device_args, "genotype", "-i", str(cram), "-r",
                       str(ref), "-d", str(db), "-p", str(prep), "-o",
                       str(tmp / "out_j"), "--seed", "1"])
    sync()
    t2 = time.perf_counter()
    check(rc == 0, f"{what}: genotype returned {rc}")
    regions = log.find(r"Indexed input: fetching (\d+) locus region")
    check(regions == str(len(loci)), f"{what}: genotype fetched {regions} "
          "locus regions by the index")
    check_calls(what, tmp / "out_j", loci)
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if torch.cuda.is_available() else float("nan"))
    rc = cli.main([*device_args, "genotype", "-i", str(bam), "-r", str(ref),
                   "-d", str(db), "-p", str(prep), "-o",
                   str(tmp / "out_j_bam"), "--stop-after", "recruit"])
    sync()
    t3 = time.perf_counter()
    check(rc == 0, f"{what}: genotype from the BAM returned {rc}")
    got = rec.recruited["out_j"]
    check(rec.recruited["out_j_bam"] == got,
          f"{what}: the BAM's recruited reads differ from the CRAM's")
    names = [lc.name for lc in loci]
    stream = list(inputs.indexed_read_iter(
        inputs.indexed_plan([cram], reference=str(ref)),
        G._load_ref_intervals(db, names), reference=str(ref)))
    check_against_host(f"{what}, the fetched stream",
                       {n: G.load_locus(db, n) for n in names},
                       {n: (None, v) for n, v in got.items()}, iter(stream),
                       rp)
    n_unplaced = sum(len(unplaced.intersection(v)) for v in got.values())
    check(n_unplaced > 0, f"{what}: no unplaced pair was recruited")
    print(f"main path {what}: {wgs['reads'][0].shape[0]} pairs written to "
          f"wgs.cram and wgs.bam in {t_write:.2f} s ({len(unplaced)} "
          f"unplaced), indexed in {t_index:.2f} s; preproc -a wgs.cram "
          f"{t1 - t0:.2f} s ({fetched} pairs fetched; insert {insert:.1f}, "
          f"depth {depth:.2f}x, mismatches {100 * mism:.4f} %), genotype -i "
          f"wgs.cram {t2 - t1:.2f} s ({len(stream)} pairs fetched, "
          f"{sum(map(len, got.values()))} recruited, {n_unplaced} of them "
          f"unplaced; {len(loci)}/{len(loci)} res.json.gz name the truth), "
          f"genotype -i wgs.bam --stop-after recruit {t3 - t2:.2f} s (the "
          f"same reads); peak device memory {peak:.0f} MiB; launches "
          f"{dict(_kernels.LAUNCHES)}", flush=True)


# -- (a-m16), (a-priors), (a-knobs): genotype options on (a')'s files -------

def write_priors(path, loci):
    """For each locus: the truth at 0, two other genotypes at -1 and -2 and
    one at -inf (log10).  Returns {locus: the finite genotypes, sorted}."""
    lines, listed = [], {}
    for lc in loci:
        names = lc.hap_names
        truth = sorted(names[i] for i in lc.true_genotype)
        others = [[names[a], names[b]] for a in range(len(names))
                  for b in range(a, len(names))
                  if [names[a], names[b]] != truth]
        for gt, prior in zip([truth] + others[:3], ("0", "-1", "-2", "-inf")):
            lines.append(f"{lc.name}\t{','.join(gt)}\t{prior}")
        listed[lc.name] = {tuple(g) for g in [truth] + others[:2]}
    path.write_text("\n".join(lines) + "\n")
    return listed


def run_option_cli(key, tmp, loci, fq1, fq2, rec, device_args=()):
    """(a-m16), (a-priors) or (a-knobs): (a')'s files, database and
    background through `genotype` with options; every call must equal the
    truth and (a')'s call."""
    calls = []
    if key == "a-m16":
        calls.append(("out_m16", ["-m", "16,10"]))
    elif key == "a-priors":
        listed = write_priors(tmp / "priors.tsv", loci)
        calls.append(("out_priors", ["--priors", str(tmp / "priors.tsv")]))
    else:
        calls += [("out_knobs_model", MODEL_KNOBS),
                  ("out_knobs_filter", FILTER_KNOBS)]
    notes = []
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    for out_name, extra in calls:
        secs, _ = run_genotype_cli(f"({key}) genotype {' '.join(extra)}",
                                   tmp, loci, fq1, fq2, out_name, extra,
                                   device_args)
        notes.append(f"genotype {' '.join(extra)} {secs:.2f} s")
    if key == "a-m16":
        n = sum(map(len, rec.recruited["out_m16"].values()))
        notes.append(f"{n} pairs recruited at k = 16 (k = 15: "
                     f"{sum(map(len, rec.recruited['out'].values()))})")
    elif key == "a-priors":
        for lc in loci:
            with gzip.open(paths.locus_dir(tmp / "out_priors", lc.name)
                           / paths.RES_JSON, "rt") as f:
                res = json.load(f)
            got = {tuple(sorted(o["genotype"].split(",")))
                   for o in res["options"]}
            check(got == listed[lc.name], f"(a-priors) {lc.name}: options "
                  f"{sorted(got)}, the file's finite genotypes "
                  f"{sorted(listed[lc.name])}")
        notes.append("every locus's options are the file's 3 finite "
                     "genotypes")
    else:
        for lc in loci:
            ldir = paths.locus_dir(tmp / "out_knobs_filter", lc.name)
            for fn in DEBUG_FILES:
                check((ldir / fn).exists(),
                      f"(a-knobs) --debug 2: {lc.name}/{fn} missing")
        notes.append(f"--debug 2 wrote {', '.join(DEBUG_FILES)} for every "
                     "locus")
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if torch.cuda.is_available() else float("nan"))
    print(f"main path ({key}) command line: {'; '.join(notes)}; "
          f"{len(loci)}/{len(loci)} res.json.gz name the truth and equal "
          f"(a')'s calls in every call; peak device memory {peak:.0f} MiB; "
          f"launches {dict(_kernels.LAUNCHES)}", flush=True)


# -- (f): the reference's 100-locus panel through add and genotype ----------

def build_panel_sample(rng, n_loci=PANEL_LOCI,
                       background_multiple=BACKGROUND_MULTIPLE):
    """extra/panel_setup.py:make_panel(n_loci)'s panel with the port's
    sim.py: n_loci loci x 6 haplotypes of 4 kb between n_loci + 1 random
    flanks of 20 kb; 15x pairs from each locus's true genotype
    (`simulate_paired_reads`, (a)'s error model), and background from the
    flanks at background_multiple x 15x, drawn by `sample_pairs` (0.2 %
    substitutions, no indels).  Returns (loci, genome, (names, reads1,
    reads2) of the locus pairs, (bg1, bg2) [N, 150] arrays)."""
    loci = [sim.simulate_locus(rng, f"B{i}", length=4000, n_haps=6,
                               divergence=0.015) for i in range(n_loci)]
    genome, flanks, _ = build_genome(loci, rng, 20000)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    pools = [sim.simulate_paired_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=DEPTH,
        read_len=150, errors=err, prefix=locus.name) for locus in loci]
    locus_reads = tuple([x for p in pools for x in getattr(p, f)]
                        for f in ("names", "reads1", "reads2"))
    background = sample_pairs(rng, flanks, DEPTH * background_multiple,
                              err.mismatch)[:2]
    return loci, genome, locus_reads, background


def write_panel_fastq(tmp, locus_reads, background):
    """Two gzip FASTQ files: the locus pairs (of unequal lengths) read by
    read, then the background appended as one gzip member, named
    `bg<index, 8 digits>`."""
    fq1, fq2 = write_fastq_pair(tmp, *locus_reads)
    write_fastq_arrays(fq1, background[0], "bg", mode="ab")
    write_fastq_arrays(fq2, background[1], "bg", mode="ab")
    return fq1, fq2


def first_pairs(locus_reads, background, n):
    """The first n pairs of `write_panel_fastq`'s files, as (name, mate 1,
    mate 2)."""
    yield from itertools.islice(zip(*locus_reads), n)
    for i in range(max(0, min(n - len(locus_reads[0]),
                              background[0].shape[0]))):
        yield f"bg{i:08d}", background[0][i], background[1][i]


def run_panel_path(what, tmp, loci, genome, fq1, fq2, out_name,
                   device_args=(), saved_at=None):
    """`add` for the panel's loci, then `genotype` with the default scheme
    from FASTQ to one res.json.gz a locus in `tmp / out_name`, on the
    default device (CUDA); every call must equal the truth.  `saved_at`
    ({output name: host clock of the first recruited-read checkpoint}, the
    Recorder's) splits recruitment from alignment.  Returns (database, the
    index's key count, the `genotype` arguments to run it again, the calls
    by locus)."""
    ref, bed = write_locus_files(what, tmp, loci, genome,
                                 locus_starts(genome, loci))
    db, prep, out = tmp / "db", tmp / "sample", tmp / out_name
    t0 = time.perf_counter()
    rc = cli.main([*device_args, "add", "-d", str(db), "-r", str(ref),
                   "-l", str(bed), "-s", str(tmp / "haps_{}.fa")])
    check(rc == 0, f"{what}: add returned {rc}")
    paths.bg_dir(prep).mkdir(parents=True)
    make_bg().save(paths.bg_dir(prep) / paths.BG_DISTR)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    genotype = [*device_args, "genotype", "-i", str(fq1), str(fq2), "-d",
                str(db), "-p", str(prep), "-o", str(out), "--seed", "1"]
    with LogLines() as log:
        rc = cli.main(genotype)
        sync()
    t2 = time.perf_counter()
    check(rc == 0, f"{what}: genotype returned {rc}")
    results = check_calls(what, out, loci)
    n_keys = int(log.find(r"Recruitment index: (\d+) minimizers"))
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if torch.cuda.is_available() else float("nan"))
    legs = ""
    if saved_at is not None and out.name in saved_at:
        # database / recruitment / alignment / solving / writing
        marks = [t1, log.when("Recruitment index"), saved_at[out.name],
                 log.when("Aligned "), log.when(r"\[\S+\] GT = "), t2]
        legs = " (database / recruitment / alignment / solving / writing " \
            + " / ".join(f"{b - a:.2f}" for a, b in zip(marks, marks[1:])) \
            + " s)"
    print(f"main path {what}: add {t1 - t0:.2f} s, genotype (FASTQ to "
          f"res.json.gz) {t2 - t1:.2f} s{legs}; recruitment index "
          f"{n_keys} keys; {len(loci)}/{len(loci)} "
          f"res.json.gz name the truth; peak device memory {peak:.0f} MiB; "
          f"launches {dict(_kernels.LAUNCHES)}", flush=True)
    return db, n_keys, genotype + ["--rerun", "all"], {
        name: res["genotype"] for name, res in results.items()}


def check_panel_index(what, db, names, rp, n_keys):
    """The loci's data from the database, and their recruitment index built
    as `recruit_reads_fast` builds it: it must have the command line's key
    count and one bitmap word for every 32 loci."""
    data = {n: G.load_locus(db, n) for n in names}
    index = TargetIndex(rp)
    for name in names:
        index.add_locus(data[name].contig_set, data[name].kmer_counts)
    index.finalize()
    dev = R.DeviceIndex.from_index(index)
    check(dev.keys.size == n_keys and dev.n_groups == -(-len(names) // 32),
          f"{what}: index of {dev.keys.size} keys (the command line's "
          f"{n_keys}), n_groups {dev.n_groups}")
    print(f"index {what}: {dev.keys.size} keys over {dev.n_loci} loci, "
          f"n_groups {dev.n_groups}, rows of {dev.packed.shape[1]} words",
          flush=True)
    return data


# -- (g): extra/hla_scale.py's panel through add and genotype ----------------

def build_hla_panel(rng, n_loci=HLA_LOCI, n_clades=10, haps_per_clade=20,
                    length=4000):
    """extra/hla_scale.py:build_panel's panel with the port's sim.py and
    that script's defaults: n_loci structured loci (n_clades clades of
    haps_per_clade haplotypes, 2 % between clades, 0.3 % within), 20 kb
    flanks between them, 15x pairs from each true genotype and 15x from the
    flanks.  Returns (loci, genome, (names, reads1, reads2))."""
    loci = [sim.simulate_structured_locus(
        rng, f"HLA{i}", length=length, n_clades=n_clades,
        haps_per_clade=haps_per_clade, clade_divergence=0.02,
        within_divergence=0.003) for i in range(n_loci)]
    genome, _, reads = build_sample(loci, rng, 1)
    return loci, genome, reads


_WORKER = r"""
import json, sys
from locityper_tpu_torch import _kernels, cli
rc = cli.main(sys.argv[1:])
print("launches " + json.dumps(_kernels.LAUNCHES), flush=True)
sys.exit(rc)
"""


def run_processes(what, tmp, loci, argv, out_name, calls):
    """`argv` (a `genotype` command line writing to `tmp / out_name`) as
    WORLD processes of the port's command line, joined through the
    environment that `torchrun` sets, all on this machine's default device.
    Every process must exit 0, the cost-weighted LPT split must give each
    its share of the loci, every locus must be genotyped by one process and
    called as in `calls`.  Returns each process's launch counts."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parent)
    argv = [*argv[:argv.index("-o") + 1], str(tmp / out_name),
            *argv[argv.index("-o") + 2:]]
    procs, logs = [], []
    try:
        t0 = time.perf_counter()
        for rank in range(WORLD):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(WORLD),
                       RANK=str(rank), PYTHONPATH=os.pathsep.join(
                           [root, os.environ.get("PYTHONPATH", "")]))
            logs.append(tmp / f"{out_name}.{rank}.log")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _WORKER, *argv], env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        walls = [None] * WORLD
        while None in walls:
            check(time.perf_counter() - t0 < WORLD_TIMEOUT,
                  f"{what}: processes still running after {WORLD_TIMEOUT} s")
            for rank, proc in enumerate(procs):
                if walls[rank] is None and proc.poll() is not None:
                    walls[rank] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    texts = [log.read_text() for log in logs]
    for rank, (proc, text) in enumerate(zip(procs, texts)):
        check(proc.returncode == 0, f"{what}: process {rank} exited "
              f"{proc.returncode}:\n{text[-3000:]}")
    names = [lc.name for lc in loci]
    shares = []
    for rank, text in enumerate(texts):
        m = re.search(rf"Host {rank}/{WORLD} takes (\d+)/{len(loci)} loci",
                      text)
        check(m, f"{what}: process {rank} logged no share of the loci")
        shares.append(int(m.group(1)))
    done = [{n for n in names if f"[{n}] GT =" in text} for text in texts]
    check(sorted(shares) == sorted(
        len(loci) // WORLD + (r < len(loci) % WORLD) for r in range(WORLD))
        and [len(d) for d in done] == shares
        and set().union(*done) == set(names)
        and sum(shares) == len(names),
        f"{what}: shares {shares}, loci genotyped {done}")
    got = {name: res["genotype"]
           for name, res in check_calls(what, tmp / out_name, loci).items()}
    check(got == calls, f"{what}: calls {got}, one process's {calls}")
    launches = [json.loads(re.findall(r"^launches (.*)$", text, re.M)[-1])
                for text in texts]
    print(f"main path {what}: {WORLD} processes, exit codes "
          f"{[p.returncode for p in procs]}, loci {shares} "
          f"({[sorted(d) for d in done]}), wall "
          + " / ".join(f"{w:.2f}" for w in walls) + " s; "
          f"{len(loci)}/{len(loci)} res.json.gz equal the one-process calls; "
          f"launches {launches}", flush=True)
    return launches


# -- (h): a CYP2D6/CYP2D7-like paralog locus (BASELINE config 3) ------------

def build_paralog_sample(rng):
    """(h)'s world and samples.  One structured locus of PARALOG_LOCUS bp (2
    clades of 4 haplotypes, 2 % between clades, 0.3 % within) and its
    paralog (`sim.make_paralog` of the first haplotype at
    PARALOG_IDENTITY), 10 kb downstream on one contig between random flanks
    of 20 kb; reads of (h) (the true genotype), (h-P3) (three distinct
    haplotypes) and (h-P1) (both copies of one haplotype), each with the
    paralog and the flanks.  Returns a dict: locus, flanks, genome, truth
    and reads by path."""
    locus = sim.simulate_structured_locus(
        rng, "CYP", length=PARALOG_LOCUS, n_clades=2, haps_per_clade=4,
        clade_divergence=0.02, within_divergence=0.003)
    paralog = sim.make_paralog(rng, locus.haplotypes[0],
                               identity=PARALOG_IDENTITY)
    flanks = [sim.random_genome(rng, n) for n in (20_000, 10_000, 20_000)]
    genome = np.concatenate([flanks[0], locus.haplotypes[0], flanks[1],
                             paralog, flanks[2]])
    truth = {"h": locus.true_genotype,
             "h-P3": tuple(sorted(rng.choice(len(locus.haplotypes), 3,
                                             replace=False).tolist())),
             "h-P1": (locus.true_genotype[0],)}
    reads = {key: paralog_reads(rng, locus, paralog, flanks,
                                haps if key != "h-P1" else haps * 2)
             for key, haps in truth.items()}
    return dict(locus=locus, flanks=flanks, genome=genome, truth=truth,
                reads=reads)


def paralog_reads(rng, locus, paralog, flanks, haps):
    """Pairs from the haplotypes `haps` at DEPTH each, from both sample
    copies of the paralog at DEPTH each, and 10x from the flanks, with
    (a)'s error model; named `hap*`, `para*` and `flank*`."""
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    pools = [
        sim.simulate_paired_reads(rng, [locus.haplotypes[i] for i in haps],
                                  depth=DEPTH, errors=err, prefix="hap"),
        sim.simulate_paired_reads(rng, [paralog, paralog], depth=DEPTH,
                                  errors=err, prefix="para"),
        sim.simulate_paired_reads(rng, flanks, depth=10.0, errors=err,
                                  prefix="flank")]
    return tuple([x for p in pools for x in getattr(p, f)]
                 for f in ("names", "reads1", "reads2"))


def add_one_locus(what, tmp, locus, genome, start, device_args=()):
    """`add` of one locus whose first haplotype sits in `genome` at
    `start`, with the whole contig as the reference (so that its k-mer
    counts see every copy); returns (database, seconds)."""
    ref, bed = write_locus_files(what, tmp, [locus], genome, [start])
    t0 = time.perf_counter()
    rc = cli.main([*device_args, "add", "-d", str(tmp / "db"), "-r",
                   str(ref), "-l", str(bed), "-s", str(tmp / "haps_{}.fa")])
    check(rc == 0, f"{what}: add returned {rc}")
    return tmp / "db", time.perf_counter() - t0


def run_locus_genotype(what, tmp, locus, fq, out_name, truth, extra=(),
                       device_args=()):
    """`genotype` of one locus from `fq` with the database and background
    in `tmp`, default scheme; the call must name the haplotypes `truth`.
    Returns (seconds, res.json.gz, peak device memory in MiB)."""
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main([*device_args, "genotype", "-i", *map(str, fq), "-d",
                   str(tmp / "db"), "-p", str(tmp / "sample"), "-o",
                   str(tmp / out_name), "--seed", "1", *extra])
    sync()
    secs = time.perf_counter() - t0
    check(rc == 0, f"{what}: genotype returned {rc}")
    with gzip.open(paths.locus_dir(tmp / out_name, locus.name)
                   / paths.RES_JSON, "rt") as f:
        res = json.load(f)
    want = sorted(locus.hap_names[i] for i in truth)
    check(sorted(res["genotype"].split(",")) == want,
          f"{what}: called {res['genotype']}, truth {want}")
    check(np.isfinite(res["quality"])
          and np.isfinite(res["options"][0]["lik_mean"]),
          f"{what}: non-finite result")
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if torch.cuda.is_available() else float("nan"))
    return secs, res, peak


def run_h_path(tmp, hw, rec, device_args=()):
    """(h): `add` of the paralog locus, the saved background, every
    sample's FASTQ files, then `genotype` of (h); some reads of the paralog
    must be recruited."""
    tmp.mkdir()
    locus = hw["locus"]
    hw["db"], t_add = add_one_locus("(h)", tmp, locus, hw["genome"],
                                    hw["flanks"][0].size, device_args)
    paths.bg_dir(tmp / "sample").mkdir(parents=True)
    make_bg().save(paths.bg_dir(tmp / "sample") / paths.BG_DISTR)
    hw["fq"] = {}
    for key, reads in hw["reads"].items():
        (tmp / key).mkdir()
        hw["fq"][key] = write_fastq_pair(tmp / key, *reads)
    secs, hw["res"], peak = run_locus_genotype(
        "(h)", tmp, locus, hw["fq"]["h"], "out_h", hw["truth"]["h"],
        device_args=device_args)
    names = rec.recruited["out_h"][locus.name]
    n_para = sum(n.startswith("para") for n in names)
    check(n_para > 0, "(h): no read of the paralog was recruited")
    print(f"main path (h) paralog locus, command line: add {t_add:.2f} s, "
          f"genotype {secs:.2f} s; {len(names)} of "
          f"{len(hw['reads']['h'][0])} pairs recruited, {n_para} of them "
          f"from the paralog; 1/1 res.json.gz names the truth "
          f"{hw['res']['genotype']} (quality {hw['res']['quality']:.1f}); "
          f"peak device memory {peak:.0f} MiB; launches "
          f"{dict(_kernels.LAUNCHES)}", flush=True)


def run_h_ploidy_path(key, ploidy, tmp, hw, rec, device_args=()):
    """(h-P3), (h-P1): `genotype -P <ploidy>` on (h)'s database."""
    locus = hw["locus"]
    secs, res, peak = run_locus_genotype(
        f"({key})", tmp, locus, hw["fq"][key], f"out_{key}",
        hw["truth"][key], extra=["-P", str(ploidy)],
        device_args=device_args)
    check(res["genotype"].count(",") == ploidy - 1,
          f"({key}): called {res['genotype']}")
    print(f"main path ({key}) paralog locus, command line: genotype -P "
          f"{ploidy} {secs:.2f} s; "
          f"{len(rec.recruited[f'out_{key}'][locus.name])} of "
          f"{len(hw['reads'][key][0])} pairs recruited; 1/1 res.json.gz "
          f"names the truth {res['genotype']} (quality "
          f"{res['quality']:.1f}); peak device memory {peak:.0f} MiB; "
          f"launches {dict(_kernels.LAUNCHES)}", flush=True)


def run_h_w_path(tmp, hw, device_args=()):
    """(h-w): (h)'s files with `--reg-weights`; the top likelihood must
    differ from (h)'s."""
    mapping = write_reg_weights(tmp, hw["locus"])
    secs, res, peak = run_locus_genotype(
        "(h-w)", tmp, hw["locus"], hw["fq"]["h"], "out_h-w",
        hw["truth"]["h"], extra=["--reg-weights", str(mapping)],
        device_args=device_args)
    lik, lik_h = (r["options"][0]["lik_mean"] for r in (res, hw["res"]))
    check(lik != lik_h, f"(h-w): top likelihood {lik} equals (h)'s: the "
          "weights were not applied")
    print(f"main path (h-w) paralog locus, command line: genotype "
          f"--reg-weights {secs:.2f} s; 1/1 res.json.gz names the truth; "
          f"top lik_mean {lik:.4f} (log10; (h) {lik_h:.4f}); peak device "
          f"memory {peak:.0f} MiB; launches {dict(_kernels.LAUNCHES)}",
          flush=True)


def write_reg_weights(tmp, locus, weight=0.1):
    """(h-w)'s `--reg-weights` mapping: every haplotype weighted `weight`
    over its middle half, a stretch that it shares with the paralog."""
    lo, hi = PARALOG_LOCUS // 4, 3 * PARALOG_LOCUS // 4
    bed = tmp / "weights.bed"
    bed.write_text("".join(f"{name}\t{lo}\t{hi}\t{weight}\n"
                           for name in locus.hap_names))
    mapping = tmp / "weights.tsv"
    mapping.write_text(f"{locus.name}\t{bed.name}\n")
    return mapping


# -- (i): HiFi reads through add, preproc --tech hifi and genotype ----------

def build_hifi_sample(rng, locus_len=HIFI_LOCUS, flank=50_000,
                      read_len=(15_000, 2_000), depth=10.0):
    """One locus of `locus_len` bp (4 haplotypes, 1.2 % divergence) between
    random flanks of `flank`; HiFi-like single reads of `read_len` (mean,
    sd) with 0.1 % errors, at `depth` from each haplotype of the true
    genotype and from each of the sample's two copies of the flanks, so
    that the background region and the locus have one depth a copy.
    Returns a dict: locus, genome, reads ((names, sequences))."""
    locus = sim.simulate_locus(rng, "HIFI", length=locus_len, n_haps=4,
                               divergence=0.012)
    left, right = sim.random_genome(rng, flank), sim.random_genome(rng, flank)
    genome = np.concatenate([left, locus.haplotypes[0], right])
    err = sim.ErrorModel(mismatch=0.0006, insertion=0.0002, deletion=0.0002)
    pools = [
        sim.simulate_single_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=depth, read_len_mean=read_len[0], read_len_sd=read_len[1],
            errors=err, prefix="hifi"),
        sim.simulate_single_reads(
            rng, [left, right] * 2, depth=depth, read_len_mean=read_len[0],
            read_len_sd=read_len[1], errors=err, prefix="bg")]
    return dict(locus=locus, genome=genome,
                reads=([n for p in pools for n in p.names],
                       [r for p in pools for r in p.reads1]))


def run_hifi_path(tmp, iw, rec, device_args=()):
    """(i): `add`, `preproc --tech hifi -b <the left flank> --max-reads
    2000` and `genotype` through the command line; the call must equal the
    truth.  The recorder's phase is `preproc` during `preproc`, so that
    its widest launches are kept apart from those of `genotype`."""
    tmp.mkdir()
    locus, genome, reads = iw["locus"], iw["genome"], iw["reads"]
    flank = (genome.size - locus.haplotypes[0].size) // 2
    fq = tmp / "hifi.fq.gz"
    with gzip.open(fq, "wt", compresslevel=1) as f:
        for name, seq in zip(*reads):
            fastx.write_fastq(f, fastx.Read(name, seq))
    iw["db"], t_add = add_one_locus("(i)", tmp, locus, genome, flank,
                                    device_args)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    rec.phase = "preproc"
    t0 = time.perf_counter()
    with LogLines() as log:
        rc = cli.main([*device_args, "preproc", "-i", str(fq), "-r",
                       str(tmp / "ref.fa"), "-o", str(tmp / "sample"),
                       "--tech", "hifi", "-b", f"chr1:1-{flank}",
                       "--max-reads", "2000"])
    sync()
    t_pre = time.perf_counter() - t0
    rec.phase = None
    check(rc == 0, f"(i): preproc returned {rc}")
    recruited = int(log.find(r"Recruited (\d+) read"))
    bg = BgDistr.load(paths.bg_dir(tmp / "sample") / paths.BG_DISTR)
    check(bg.seq_info.technology == Technology.HIFI,
          f"(i): preproc wrote technology {bg.seq_info.technology}")
    secs, res, peak = run_locus_genotype("(i)", tmp, locus, [fq], "out_i",
                                         locus.true_genotype,
                                         device_args=device_args)
    print(f"main path (i) HiFi, command line: add, preproc --tech hifi, "
          f"genotype: {len(reads[0])} reads, "
          f"{sum(r.size for r in reads[1]):,} bases, longest "
          f"{max(r.size for r in reads[1]):,}; add {t_add:.2f} s, preproc "
          f"{t_pre:.2f} s ({recruited} reads recruited to the background "
          f"region; read length {bg.seq_info.read_len:.0f}, mismatches "
          f"{100 * float(np.exp(bg.err_prof.ln_mismatch)):.4f} %), genotype "
          f"{secs:.2f} s; {len(rec.recruited['out_i'][locus.name])} reads "
          f"recruited, 1/1 res.json.gz names the truth {res['genotype']} "
          f"(quality {res['quality']:.1f}); peak device memory {peak:.0f} "
          f"MiB; launches {dict(_kernels.LAUNCHES)}", flush=True)


def check_h_i_recruitment(hw, iw, rec, rp):
    """(h)'s and (i)'s recruited reads against the host engine's."""
    locus = hw["locus"]
    check_against_host(
        f"(h), all {len(hw['reads']['h'][0]):,} pairs",
        {locus.name: G.load_locus(hw["db"], locus.name)},
        {n: (None, v) for n, v in rec.recruited["out_h"].items()},
        zip(*hw["reads"]["h"]), rp)
    locus = iw["locus"]
    check_against_host(
        f"(i), all {len(iw['reads'][0])} reads",
        {locus.name: G.load_locus(iw["db"], locus.name)},
        {n: (None, v) for n, v in rec.recruited["out_i"].items()},
        ((n, r, None) for n, r in zip(*iw["reads"])),
        RecruitParams(match_frac=Technology.HIFI.default_match_frac(False),
                      match_length=2000), ordered=False)


def hold_anneal_mode(rec, key, mode):
    """The annealer's largest launch of `mode` on path `key` against the
    plain version: polish only whole, the stage-2 launch with its schedule
    cut to K2_CUT (and the kernel timed on the whole of it)."""
    check((key, mode) in rec.anneal_by_path,
          f"({key}): no {mode} launch of anneal_chains")
    args, kw, _ = rec.anneal_by_path[(key, mode)]
    what, whole = f"({key}) {mode} launch", ""
    whole_ms = None
    if mode == "anneal":
        whole_ms = time_ms(lambda: SC.anneal_chains(*args, **kw))
        whole = (f"; the whole launch ({kw['n_steps']:,} steps) "
                 f"{whole_ms:.3f} ms")
        kw = cut_schedule(kw, *K2_CUT)
        what += f", cut to {K2_CUT[0]:,} + {K2_CUT[1]:,} steps"
    m = compare_anneal(args, kw, what, timed=True)
    m["whole_ms"] = whole_ms
    print(f"{what} of anneal_chains {m['shape']}: equals plain exactly; "
          f"{m['moves']} moves proposed, {m['rounds_per_batch']:.2f} "
          f"evaluation rounds a batch; {m['ms']:.3f} ms (plain "
          f"{m['plain_ms']:.0f} ms, bound {m['bound_ms']:.4f} ms by "
          f"{m['bound_by']}){whole}", flush=True)
    return m


def hold_ploidy_launches(rec):
    """(h-P3) and (h-P1): the annealer at ploidy 3 and 1, K = P Kh + 1 slots
    (or the cap k_eff) and W = 2 + P max_windows windows, each mode's
    largest launch of the path (`hold_anneal_mode`).  (h-P1)'s 8 genotypes
    skip the greedy stage, so it has no polish-only launch.  Returns
    {mode_P<p>: numbers}."""
    return {f"{mode}_P{ploidy}": hold_anneal_mode(rec, key, mode)
            for key, ploidy, modes in (("h-P3", 3, ("polish", "anneal")),
                                       ("h-P1", 1, ("anneal",)))
            for mode in modes}


def hold_long_launches(rec, path):
    """(i), (k): K1 on the widest launch of the path's `preproc` (band 48:
    the background estimation aligns at band 48 whatever the technology, in
    the JAX package too) and of its `genotype` (band 160), each on 8 of its
    jobs longer than LONG_ROWS.  Returns {key: numbers}."""
    held = {}
    for key, want_band in ((f"{path}-preproc", 48), (path, 160)):
        check((key, "align") in rec.widest,
              f"({key}): no launch of align_banded")
        reads, lens, wins, svec, band = rec.widest[(key, "align")]
        pick = longest_jobs(lens, LONG_ROWS)
        check(band == want_band and pick.numel() > 0,
              f"({key}): widest launch at band {band}, {pick.numel()} jobs "
              f"with reads longer than {LONG_ROWS:,}")
        m = compare_align(reads[pick], lens[pick], wins[pick], svec, band,
                          f"({key}) widest launch")
        whole_ms = time_ms(lambda: A.align_banded(reads, lens, wins, svec,
                                                  band))
        whole_bound, whole_by = align_bound_ms(reads, lens, wins, band)
        held[key] = m
        print(f"({key}) widest launch of align_banded {list(reads.shape)} "
              f"[N, L], band {band}, longest read {int(lens.max()):,}: "
              f"{whole_ms:.3f} ms (bound {whole_bound:.4f} ms by "
              f"{whole_by}); {pick.numel()} of its jobs with reads of "
              f"{int(lens[pick].min()):,} to {int(lens[pick].max()):,} "
              f"bases: all 8 outputs bit-identical, {m['ms']:.3f} ms (plain "
              f"{m['plain_ms']:.0f} ms, bound {m['bound_ms']:.4f} ms by "
              f"{m['bound_by']})", flush=True)
    return held


# -- (k): ONT reads over (h)'s locus (BASELINE config 4's ONT half) --------

def draw_single_reads(rng, copies, depth, length, errors, prefix):
    """Single reads along each sequence of `copies` at `depth` a copy, as
    `sim.simulate_single_reads` draws them (lengths N(mean, sd), at least
    300; the reverse strand in half the draws; `errors` (mismatch,
    insertion, deletion) as `sim.ErrorModel.apply`'s per-base events, drawn
    for all bases of a read at once).  Returns (names, reads, places):
    places[i] = (copy, start, span, reverse)."""
    mism_p, ins_p, del_p = errors
    names, reads, places = [], [], []
    for c, seq in enumerate(copies):
        covered = 0
        while covered < depth * seq.size:
            span = min(max(int(rng.normal(*length)), 300), seq.size)
            start = int(rng.integers(0, seq.size - span + 1))
            frag = seq[start:start + span]
            rev = bool(rng.random() < 0.5)
            if rev:
                frag = (3 - frag[::-1]).astype(np.int8)
            r = rng.random(span)
            out = frag.copy()
            mism = (r >= del_p + ins_p) & (r < del_p + ins_p + mism_p)
            out[mism] = (out[mism] + rng.integers(1, 4, int(mism.sum()))) % 4
            keep = r >= del_p
            ins = (r < del_p + ins_p)[keep]
            extra = rng.integers(0, 4, int(ins.sum())).astype(np.int8)
            reads.append(np.insert(out[keep], np.flatnonzero(ins), extra))
            names.append(f"{prefix}{len(names):06d}")
            places.append((c, start, span, rev))
            covered += span
    return names, reads, places


def build_ont_paralog_sample(hw, rng):
    """(k)'s world: (h)'s contig with its flanks lengthened by random bases
    before the left one and after the right one; the locus is (h)'s gene
    widened by K_MARGIN of the flank before it and by the spacer, the
    paralog and K_MARGIN of the flank after it, so that it can hold reads
    of ONT_READS; K_LEFT bases before the locus (the background region
    chr1:1-K_BG padded by `preproc`'s 50 kb) and K_RIGHT after the
    paralog.  Two sample copies, each with one haplotype of (h)'s truth in
    the gene's place, and ONT-like single reads along both at ONT_DEPTH a
    copy.  Returns a dict: locus (the widened one), genome, left (the
    flank outside the locus), paralog (its span on the contig), reads
    ((names, sequences)), places."""
    gene, flanks, genome_h = hw["locus"], hw["flanks"], hw["genome"]
    at = flanks[0].size + gene.haplotypes[0].size
    middle = genome_h[at:genome_h.size - flanks[2].size]  # spacer + paralog
    left = np.concatenate([
        sim.random_genome(rng, K_LEFT + K_MARGIN - flanks[0].size),
        flanks[0][:-K_MARGIN]])
    right = np.concatenate([flanks[2][K_MARGIN:],
                            sim.random_genome(rng, K_RIGHT - flanks[2].size)])
    locus = sim.SimLocus(
        gene.name, [np.concatenate([flanks[0][-K_MARGIN:], h, middle,
                                    flanks[2][:K_MARGIN]])
                    for h in gene.haplotypes],
        gene.hap_names, gene.true_genotype)
    genome = np.concatenate([left, locus.haplotypes[0], right])
    copies = [np.concatenate([left, locus.haplotypes[i], right])
              for i in locus.true_genotype]
    names, reads, places = draw_single_reads(rng, copies, ONT_DEPTH,
                                             ONT_READS, ONT_ERRORS, "ont")
    para_lo = left.size + K_MARGIN + gene.haplotypes[0].size \
        + flanks[1].size
    return dict(locus=locus, genome=genome, left=left, places=places,
                paralog=(para_lo, para_lo + middle.size - flanks[1].size),
                reads=(names, reads))


def ont_contig_positions(kw):
    """Where an aligner places each read of (k) on the contig: a read that
    starts in the locus at the locus's start plus its offset in the copy's
    haplotype (cut at the locus's end); past the locus, shifted by the
    difference of the haplotypes' lengths; its `<len>M` kept on the
    contig."""
    locus, left = kw["locus"], kw["left"].size
    lens = [locus.haplotypes[i].size for i in locus.true_genotype]
    hap0 = locus.haplotypes[0].size
    out = []
    for (c, start, _span, _rev), read in zip(kw["places"], kw["reads"][1]):
        if start < left:
            pos = start
        elif start < left + lens[c]:
            pos = left + min(start - left, hap0 - 1)
        else:
            pos = start - lens[c] + hap0
        out.append(min(pos, kw["genome"].size - read.size))
    return out


def write_ont_bam(what, tmp, kw):
    """(k)'s reads as an aligner leaves them in ont.bam: each read at its
    place with CIGAR `<len>M`, a read of the reverse strand with flag 0x10
    and its bases in contig orientation, sorted by position; indexed by
    the port's `index`.  Returns (path, seconds to write and index)."""
    t0 = time.perf_counter()
    names, reads = kw["reads"]
    recs = sorted(zip(ont_contig_positions(kw), names, reads,
                      (rev for *_, rev in kw["places"])),
                  key=lambda r: r[0])
    bam = tmp / "ont.bam"
    with tbam.BamWriter(bam, ["chr1"], [kw["genome"].size]) as bw:
        for pos, name, codes, rev in recs:
            if rev:
                codes = (3 - codes[::-1]).astype(np.int8)
            bw.write(name, tbam.FLAG_REVERSE if rev else 0, codes, ref_id=0,
                     pos=pos, cigar=[("M", int(codes.size))])
    check(cli.main(["index", str(bam)]) == 0, f"{what}: index ont.bam")
    return bam, time.perf_counter() - t0


def check_ont_estimates(what, bg, reads):
    """`preproc`'s estimates of (k)'s sample: the technology, the read
    length within 5 % of the sample's mean, the mismatch rate within a
    factor 2 of ONT_ERRORS'.  Returns (read length, depth a copy, mismatch
    rate); the depth by `check_wgs_estimates`' formula for single reads:
    the haploid read middles a window times the read length, over the
    window."""
    check(bg.seq_info.technology == Technology.NANOPORE,
          f"{what}: preproc wrote technology {bg.seq_info.technology}")
    mean_len = float(np.mean([r.size for r in reads]))
    read_len = bg.seq_info.read_len
    check(abs(read_len / mean_len - 1) <= 0.05,
          f"{what}: read length {read_len:.0f}, the sample's {mean_len:.0f}")
    mism = float(np.exp(bg.err_prof.ln_mismatch))
    check(0.5 <= mism / ONT_ERRORS[0] <= 2.0,
          f"{what}: estimated mismatch rate {mism:.5f}, simulated "
          f"{ONT_ERRORS[0]}")
    d = bg.depth.depth_distribution(41)
    return read_len, d.mean() * read_len / bg.depth.window_size, mism


def run_ont_preproc(what, tmp, inputs, sample, rec, extra=(),
                    device_args=()):
    """`preproc --tech ont -b chr1:1-K_BG --max-reads 2000` of (k), the
    recorder's phase `preproc`; returns (seconds, log, distributions)."""
    rec.phase = "preproc"
    t0 = time.perf_counter()
    with LogLines() as log:
        rc = cli.main([*device_args, "preproc", *inputs, "-r",
                       str(tmp / "ref.fa"), "-o", str(sample), "--tech",
                       "ont", "-b", f"chr1:1-{K_BG}", "--max-reads", "2000",
                       *extra])
    sync()
    secs = time.perf_counter() - t0
    rec.phase = None
    check(rc == 0, f"{what}: preproc {' '.join(extra)} returned {rc}")
    return secs, log, BgDistr.load(paths.bg_dir(sample) / paths.BG_DISTR)


def run_k_path(key, tmp, kw, rec, device_args=()):
    """(k) from FASTQ (`key` "k": `add`, `preproc --tech ont -b
    chr1:1-K_BG --max-reads 2000`, `genotype`) or from the indexed BAM ("k-bam":
    ont.bam written and indexed, `preproc -a ont.bam --tech ont ...`,
    `genotype -i ont.bam`).  The recorder's phase is `preproc` during
    `preproc`.  Returns the estimates."""
    what = f"({key})"
    locus, (names, reads) = kw["locus"], kw["reads"]
    t_add = t_write = None
    if key == "k":
        tmp.mkdir()
        fq = tmp / "ont.fq.gz"
        with gzip.open(fq, "wt", compresslevel=1) as f:
            for name, seq in zip(names, reads):
                fastx.write_fastq(f, fastx.Read(name, seq))
        kw["db"], t_add = add_one_locus(what, tmp, locus, kw["genome"],
                                        kw["left"].size, device_args)
        inputs, sample, out_name = ["-i", str(fq)], tmp / "sample", "out_k"
        kw["fq"] = fq
    else:
        bam, t_write = write_ont_bam(what, tmp, kw)
        inputs, sample, out_name = (["-a", str(bam)], tmp / "sample_bam",
                                    "out_k_bam")
        kw["bam"] = bam
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t_pre, log, bg = run_ont_preproc(what, tmp, inputs, sample, rec,
                                     device_args=device_args)
    if key == "k":
        n_bg = int(log.find(r"Recruited (\d+) read"))
    else:
        n_bg = log.find(r"Indexed input: fetched (\d+) read")
        check(n_bg is not None, f"{what}: preproc did not fetch by the index")
    est = check_ont_estimates(what, bg, reads)
    q0 = ""
    if key == "k":
        # Both packages drop a read as ambiguous (MAPQ under `-q`, 30)
        # when its two candidate windows give the same alignment, as long
        # reads' do; with `-q 0` every placed read counts, and the depth
        # must be the simulated one.
        t_q0, _, bg0 = run_ont_preproc(f"{what} -q 0", tmp, inputs,
                                       tmp / "sample_q0", rec, ["-q", "0"],
                                       device_args)
        est0 = check_ont_estimates(f"{what} -q 0", bg0, reads)
        check(abs(est0[1] / ONT_DEPTH - 1) <= 0.25,
              f"{what} -q 0: estimated depth {est0[1]:.2f}x a copy, "
              f"simulated {ONT_DEPTH}x")
        check(est[1] <= est0[1], f"{what}: depth {est[1]:.2f}x at -q 30, "
              f"{est0[1]:.2f}x at -q 0")
        q0 = (f"; preproc -q 0 {t_q0:.2f} s (depth {est0[1]:.2f}x a copy, "
              f"mismatches {100 * est0[2]:.4f} %)")
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LogLines() as log:
        rc = cli.main([*device_args, "genotype", "-i", inputs[1], "-d",
                       str(kw["db"]), "-p", str(sample), "-o",
                       str(tmp / out_name), "--seed", "1"])
    sync()
    secs = time.perf_counter() - t0
    check(rc == 0, f"{what}: genotype returned {rc}")
    if key == "k-bam":
        check(log.find(r"Indexed input: fetching (\d+) locus region") == "1",
              f"{what}: genotype did not fetch by the index")
    with gzip.open(paths.locus_dir(tmp / out_name, locus.name)
                   / paths.RES_JSON, "rt") as f:
        res = json.load(f)
    want = sorted(locus.hap_names[i] for i in locus.true_genotype)
    check(sorted(res.get("genotype", "").split(",")) == want,
          f"{what}: called {res.get('genotype')}, truth {want}")
    check(np.isfinite(res["quality"])
          and np.isfinite(res["options"][0]["lik_mean"]),
          f"{what}: non-finite result")
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if torch.cuda.is_available() else float("nan"))
    got = rec.recruited[out_name][locus.name]
    lo, hi = kw["paralog"]
    place = dict(zip(names, kw["places"]))
    n_para = sum(place[n][1] < hi and place[n][1] + place[n][2] > lo
                 for n in got)
    check(n_para > 0, f"{what}: no read over the paralog was recruited")
    head = (f"{len(reads)} reads, {sum(r.size for r in reads):,} bases, "
            f"longest {max(r.size for r in reads):,}; add {t_add:.2f} s"
            if key == "k" else
            f"ont.bam written and indexed in {t_write:.2f} s")
    print(f"main path {what} ONT over the paralog locus "
          f"({locus.haplotypes[0].size:,} bp widened), command line: {head}, "
          f"preproc {t_pre:.2f} s ({n_bg} reads "
          f"{'recruited to' if key == 'k' else 'fetched from'} the "
          f"background region; read length {est[0]:.0f}, depth "
          f"{est[1]:.2f}x a copy, mismatches {100 * est[2]:.4f} %){q0}, "
          f"genotype {secs:.2f} s; {len(got)} reads recruited, {n_para} of "
          f"them over the paralog; 1/1 res.json.gz names the truth "
          f"{res['genotype']} (quality {res['quality']:.1f}); peak device "
          f"memory {peak:.0f} MiB; launches {dict(_kernels.LAUNCHES)}",
          flush=True)
    kw.setdefault("estimates", {})[key] = est
    kw.setdefault("res", {})[key] = res


def check_k_recruitment(kw, rec, rp):
    """(k): the FASTQ run's reads against the host engine's; the BAM run's
    equal the FASTQ run's on the reads the index fetch yields; the two
    estimates within 10 % of each other; the two calls equal."""
    locus, (names, reads) = kw["locus"], kw["reads"]
    data = {locus.name: G.load_locus(kw["db"], locus.name)}
    check_against_host(f"(k), all {len(names)} reads", data,
                       {n: (None, v) for n, v in rec.recruited["out_k"]
                        .items()},
                       ((n, r, None) for n, r in zip(names, reads)), rp,
                       ordered=False)
    fetched = {name for name, _, _ in inputs.indexed_read_iter(
        inputs.indexed_plan([kw["bam"]]),
        G._load_ref_intervals(kw["db"], [locus.name]))}
    fq_reads = set(rec.recruited["out_k"][locus.name])
    bam_reads = set(rec.recruited["out_k_bam"][locus.name])
    check(bam_reads == fq_reads & fetched,
          f"(k-bam): {len(bam_reads)} reads recruited, the FASTQ run's "
          f"{len(fq_reads & fetched)} among the {len(fetched)} fetched")
    a, b = kw["estimates"]["k"], kw["estimates"]["k-bam"]
    for name, x, y in zip(("read length", "depth", "mismatch rate"), a, b):
        check(abs(y / x - 1) <= 0.10, f"(k-bam): {name} {y:.5g}, FASTQ's "
              f"{x:.5g}")
    calls = [kw["res"][k]["genotype"] for k in ("k", "k-bam")]
    check(calls[0] == calls[1], f"(k): calls {calls} differ")
    print(f"recruit (k-bam): {len(fetched)} reads fetched over the locus, "
          f"{len(bam_reads)} recruited, the FASTQ run's reads among them; "
          f"estimates within 10 % of the FASTQ run's ({a[0]:.0f} / "
          f"{b[0]:.0f} bases, {a[1]:.2f} / {b[1]:.2f}x, {100 * a[2]:.4f} / "
          f"{100 * b[2]:.4f} %)", flush=True)


def hold_widest_front(rec, key):
    """The full-width front end on the first 8 rows of path `key`'s widest
    launch of it."""
    check((key, "full") in rec.widest,
          f"({key}): no full-width launch of minimizer_front")
    reads, k, w, S = rec.widest[(key, "full")]
    m = compare_front(reads[:8].contiguous(), k, w, S,
                      f"({key}) widest full-width launch")
    print(f"({key}) widest launch of minimizer_front (full) "
          f"{list(reads.shape)} [B, L]: its first {m['shape']['B']} rows, "
          f"all outputs bit-identical; {m['ms']:.4f} ms (plain "
          f"{m['plain_ms']:.0f} ms, bound {m['bound_ms']:.4f} ms by "
          f"{m['bound_by']})", flush=True)
    return reads, m


def hold_ont_launches(rec):
    """(k): K5 and K1 on the widest launches of its `preproc` and of its
    `genotype`, K2 on each mode of its `genotype`.  Returns {name:
    numbers}."""
    held = {f"full_{key}": hold_widest_front(rec, key)[1]
            for key in ("k-preproc", "k")}
    held.update((f"align_{key}", m)
                for key, m in hold_long_launches(rec, "k").items())
    held.update((f"{mode}_k", hold_anneal_mode(rec, "k", mode))
                for mode in ("polish", "anneal"))
    return held


# -- (a-profile): genotype --profile on (a')'s files -------------------------

PROFILED = {"align_banded": "align_banded_kernel",
            "anneal_chains": "anneal_chains_kernel",
            "minimizer_front_compact": "minimizer_front_kernel"}


def run_profile_cli(tmp, loci, fq1, fq2, device_args=()):
    """(a-profile): (a')'s files through `genotype --profile <dir>`; every
    call must equal the truth and (a')'s, and on the card the trace must
    name at least one launch of K1, K2 and K3."""
    prof = tmp / "profile"
    secs, _ = run_genotype_cli("(a-profile) genotype --profile", tmp, loci,
                               fq1, fq2, "out_profile",
                               ["--profile", str(prof)], device_args)
    trace = prof / "trace.json"
    check(trace.exists(), "(a-profile): no trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = {name: sum(sym in e.get("name", "") for e in kernels)
              for name, sym in PROFILED.items()}
    busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    if not device_args:
        for name, n in counts.items():
            check(n > 0, f"(a-profile): the trace names no launch of {name} "
                  f"({len(kernels)} kernel events of {len(events)})")
    print(f"main path (a-profile) command line: genotype --profile "
          f"{secs:.2f} s; trace.json {trace.stat().st_size / 2**20:.1f} MiB, "
          f"{len(events)} events, {len(kernels)} kernel launches "
          f"({busy_ms:.1f} ms of device time), by kernel {counts}; "
          f"{len(loci)}/{len(loci)} res.json.gz name the truth and equal "
          f"(a')'s calls; launches {dict(_kernels.LAUNCHES)}", flush=True)


class LogLines(logging.Handler):
    """Collects the messages of the package's loggers while in use."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.created, record.getMessage()))

    def __enter__(self):
        logging.getLogger("locityper").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("locityper").removeHandler(self)

    def find(self, pattern):
        for _, line in self.lines:
            m = re.search(pattern, line)
            if m:
                return m.group(1)
        return None

    def when(self, start):
        """The host clock (`time.perf_counter`) of the first message that
        begins with a match of the regular expression `start`."""
        created = next(t for t, line in self.lines if re.match(start, line))
        return time.perf_counter() - (time.time() - created)


def profile_main_path(what, run):
    """One more warm run under torch.profiler: device time by kernel name
    and the device's busy share of the wall time (tracing slows the host,
    so the share is a lower bound on the untraced one)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only: an operator's row repeats its kernels' time.
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    check(rows, "torch.profiler recorded no device time")
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile {what}: wall {wall_ms:.0f} ms traced, device busy "
          f"{busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f} % "
          f"(idle {100 - 100 * busy_ms / wall_ms:.1f} %), "
          f"{len(rows)} kernel names", flush=True)
    for ms, count, key in rows[:12]:
        print(f"profile   {ms:9.3f} ms {count:6d} x {key[:90]}", flush=True)


def profile_host(what, run, top=14):
    """One more run under cProfile: the package's functions with the most
    cumulative host time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(run)
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    rows = sorted(((ct, nc, f"{Path(f).name}:{line}:{fn}")
                   for (f, line, fn), (_cc, nc, _tt, ct, _c) in stats.items()
                   if "locityper_tpu_torch" in f), reverse=True)
    print(f"profile {what}: wall {wall:.1f} s under cProfile", flush=True)
    for ct, nc, key in rows[:top]:
        print(f"profile   {ct:8.2f} s cumulative {nc:8d} calls {key}",
              flush=True)


class Recorder:
    """Keeps the inputs of the largest launch of each kernel on the main
    path (for the annealer: of each of its two modes by path;
    for the aligner: of its largest launch on rows of at most LONG_ROWS,
    and of its largest on longer rows outside (e); for the minimizer front
    end: of each of its two entries), to hold the kernel against its plain
    version and time it afterwards on inputs the path really gave it.  The
    widest launch of each kernel is also kept by path, and by phase where
    one is set (`widest`): the plain aligner walks every row of the longest
    read it is given, 99 s for (e)'s widest launch, so (e) and (i) are held
    on 8 jobs of theirs and kept out of the long-row launch."""

    def __init__(self):
        self.align = None
        self.align_long = None
        self.n_align_long = {}          # path -> launches on long rows
        self.path = None
        self.phase = None               # a part of the path kept apart
        self.anneal_by_path = {}        # (path, mode) -> (args, kw, size)
        self.front = {}                 # entry -> (reads, k, w, S); at a k
                                        # other than 15, entry_k<k>
        self.n_front_k = {}             # entry_k<k> -> launches
        self.widest = {}                # (path, kernel) -> widest launch
        self.greedy_iters = {}          # path -> [iterations of its chains]
        self.recruited = {}             # genotype -o name -> {locus: names}
        self.saved_at = {}              # genotype -o name -> first save
        self._save_recruited = G._save_recruited
        self._align_banded = A.align_banded
        self._anneal_chains = SC.anneal_chains
        self._minimizer_front = R.minimizer_front
        self._greedy_chain = SQ._greedy_chain

    def _keep_widest(self, kernel, reads, args):
        key = (self.path if self.phase is None
               else f"{self.path}-{self.phase}", kernel)
        if key not in self.widest \
                or reads.shape[1] > self.widest[key][0].shape[1]:
            self.widest[key] = args

    def largest_anneal(self):
        """mode -> (args, kw, size) of its largest launch on any path."""
        out = {}
        for (_, mode), launch in self.anneal_by_path.items():
            if mode not in out or launch[2] > out[mode][2]:
                out[mode] = launch
        return out

    def __enter__(self):
        def align_banded(reads, rlens, hap_wins, score_vec, band=48,
                         max_del_run=32):
            args = (reads, rlens, hap_wins, score_vec, band)
            if reads.shape[1] <= LONG_ROWS and (
                    self.align is None
                    or reads.numel() > self.align[0].numel()):
                self.align = args
            if reads.shape[0]:
                self._keep_widest("align", reads, args)
            if reads.shape[1] > LONG_ROWS and reads.shape[0]:
                self.n_align_long[self.path] = \
                    self.n_align_long.get(self.path, 0) + 1
                if self.path not in ("e", "i", "k", "k-bam") and (
                        self.align_long is None
                        or reads.numel() > self.align_long[0].numel()):
                    self.align_long = args
            return self._align_banded(reads, rlens, hap_wins, score_vec,
                                      band, max_del_run)

        def anneal_chains(*args, **kw):
            size = args[1].numel() * kw["n_steps"]
            mode = "anneal" if kw["anneal_steps"] > 0 else "polish"
            key = (self.path, mode)
            if key not in self.anneal_by_path \
                    or size > self.anneal_by_path[key][2]:
                self.anneal_by_path[key] = (args, kw, size)
            return self._anneal_chains(*args, **kw)

        def minimizer_front(reads, k, w, S=None):
            entry = "full" if S is None else "compact"
            if k != 15:
                entry = f"{entry}_k{k}"
                if reads.shape[0]:
                    self.n_front_k[entry] = self.n_front_k.get(entry, 0) + 1
            if entry not in self.front \
                    or reads.numel() > self.front[entry][0].numel():
                self.front[entry] = (reads, k, w, S)
            if reads.shape[0]:
                self._keep_widest(entry, reads, (reads, k, w, S))
            return self._minimizer_front(reads, k, w, S)

        def greedy_chain(*args, **kw):
            out = self._greedy_chain(*args, **kw)
            self.greedy_iters.setdefault(self.path, []).append(out[2])
            return out

        def save_recruited(ldir, pairs, names):
            self.saved_at.setdefault(ldir.parent.parent.name,
                                     time.perf_counter())
            self.recruited.setdefault(ldir.parent.parent.name, {})[
                ldir.name] = list(names)
            return self._save_recruited(ldir, pairs, names)

        A.align_banded, SC.anneal_chains = align_banded, anneal_chains
        R.minimizer_front, SQ._greedy_chain = minimizer_front, greedy_chain
        G._save_recruited = save_recruited
        return self

    def __exit__(self, *exc):
        A.align_banded, SC.anneal_chains = (self._align_banded,
                                            self._anneal_chains)
        R.minimizer_front = self._minimizer_front
        SQ._greedy_chain = self._greedy_chain
        G._save_recruited = self._save_recruited


FRONT = ("minimizer_front_compact", "minimizer_front_full")
#: kernels that each sample must launch
NEEDS = {"a": ("align_banded", "anneal_chains", FRONT[0]),
         "a_cli": ("align_banded", "anneal_chains", FRONT[0]),
         "a_seq": ("align_banded", FRONT[0]),
         "a_mesh": ("align_banded", "anneal_chains", FRONT[0]),
         "a_mesh_cards": ("align_banded", "anneal_chains", FRONT[0]),
         "a_batched": ("align_banded", FRONT[0]),
         "b": ("align_banded", "anneal_chains", FRONT[0]),
         "b_mesh": ("align_banded", "anneal_chains", FRONT[0]),
         "c": ("align_banded", "anneal_chains", FRONT[1]),
         "d": ("align_banded", "anneal_chains", FRONT[0]),
         "e": ("align_banded", "anneal_chains", FRONT[1]),
         "f": ("align_banded", "anneal_chains", FRONT[0]),
         "g": ("align_banded", "anneal_chains", FRONT[0]),
         "g_2proc": ("align_banded", "anneal_chains", FRONT[0]),
         "h": ("align_banded", "anneal_chains", FRONT[0]),
         "h-P3": ("align_banded", "anneal_chains", FRONT[0]),
         "h-P1": ("align_banded", "anneal_chains", FRONT[0]),
         "h-w": ("align_banded", "anneal_chains", FRONT[0]),
         "i": ("align_banded", "anneal_chains", FRONT[1]),
         "j": ("align_banded", "anneal_chains", FRONT[0]),
         "a-m16": ("align_banded", "anneal_chains", FRONT[0]),
         "a-priors": ("align_banded", "anneal_chains", FRONT[0]),
         "a-knobs": ("align_banded", "anneal_chains", FRONT[0]),
         "a-profile": ("align_banded", "anneal_chains", FRONT[0]),
         "k": ("align_banded", "anneal_chains", FRONT[1]),
         "k-bam": ("align_banded", "anneal_chains", FRONT[1])}
#: kernels that a sample must not launch: (a-seq) and (a-batched) solve
#: with the sequential and the batched-move engines, which have no kernel of
#: their own
NEVER = {"a_seq": ("anneal_chains",), "a_batched": ("anneal_chains",)}


def print_resources():
    """Compiles every source once more with `-Xptxas -v` (the library's own
    flags otherwise, output thrown away) and prints, for every kernel
    instantiation, the registers a thread and the bytes spilled to local
    memory as ptxas reports them."""
    nvcc = _kernels._find_nvcc()
    filt = Path(nvcc).with_name("cu++filt")
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted({s for s, _fn, _at in _kernels.KERNELS.values()}):
            out = subprocess.run(
                [nvcc, *_kernels.ARCH_FLAGS, *_kernels.COMMON_FLAGS,
                 "-Xptxas", "-v", "-o", str(Path(tmp) / "resources.so"),
                 str(_kernels.CSRC / src)],
                capture_output=True, text=True, check=True, timeout=600)
            report = re.findall(
                r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                r"Used (\d+) registers", out.stderr, flags=re.S)
            check(report, f"no ptxas report for {src}:\n{out.stderr}")
            for name, stack, stores, loads, regs in report:
                if filt.exists():
                    name = subprocess.run(
                        [str(filt), name], capture_output=True, text=True,
                        check=True, timeout=60).stdout.strip()
                    name = name.rpartition("(")[0].replace("(int)", "") \
                        .replace("(bool)", "")
                print(f"resources {src} {name}: {regs} registers, stack "
                      f"{stack} B, spill stores {stores} B, spill loads "
                      f"{loads} B", flush=True)


def main():
    options = set(sys.argv[1:])
    want_profile = "--profile" in options
    want_resources = "--resources" in options
    if options - {"--profile", "--resources"}:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    n_cards = torch.cuda.device_count()
    cards_grid = M.auto_mesh()
    print(f"cards: torch.cuda.device_count() = {n_cards}; (a-mesh) and "
          f"(b-mesh) run {GRID} shards on card 0; "
          + (f"(a-mesh) once more over the real auto_mesh(), {cards_grid}"
             if cards_grid is not None else
             "auto_mesh() gives no grid, so no run over distinct cards"),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _kernels.load()
    sources = sorted({src for src, _fn, _at in _kernels.KERNELS.values()})
    print(f"build: {len(sources)} sources {sources} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if want_resources:
        print_resources()

    sv = torch.tensor(A.Scores.from_error_rates(0.002, 0.0002, 0.0002)
                      .astuple(), dtype=torch.float32, device="cuda")
    for N, L, band in ((32768, 192, 48), (1024, 2048, 160)):
        jobs = make_align_jobs(N, N, L, band)
        r = compare_align(*jobs, sv, band, f"{N}x{L} band {band}")
        print(f"K1 {N} jobs L={L} band={band}: all 8 outputs bit-identical; "
              f"{r['ms']:.3f} ms/launch, {N / r['ms'] * 1e3:.3e} jobs/s "
              f"(plain {r['plain_ms']:.0f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']})", flush=True)
    # Every compiled variant of K1 (1..8 band cells a lane; band 40 leaves
    # cells of the half-warp variant unused).
    bands = (20, 40, 64, 96, 128, 192, 224, 256)
    for band in bands:
        jobs = make_align_jobs(band, 2048, 128, band)
        compare_align(*jobs, sv, band, f"2048x128 band {band}", timed=False)
    print(f"K1 2048 jobs L=128 bands {list(bands)}: all 8 outputs "
          "bit-identical", flush=True)
    phase_k1_edges(sv)
    phase_k2()
    phase_front()
    phase_seq()
    phase_batched()

    rng = np.random.default_rng(0)
    panel_loci = [sim.simulate_locus(rng, f"B{i}", length=4000, n_haps=6,
                                     divergence=0.015) for i in range(4)]
    panel_genome, panel_data, panel_reads = build_sample(
        panel_loci, rng, BACKGROUND_MULTIPLE)
    hla_loci = [sim.simulate_structured_locus(
        rng, "HLA0", length=4000, n_clades=10, haps_per_clade=20,
        clade_divergence=0.02, within_divergence=0.003)]
    _, hla_data, hla_reads = build_sample(hla_loci, rng, 1)
    rng_long = np.random.default_rng(7)
    long_loci = [sim.simulate_locus(rng_long, f"L{i}", length=16384, n_haps=4,
                                    divergence=0.01) for i in range(3)]
    long_data, (long_names, long_reads) = build_long_sample(long_loci,
                                                            rng_long)
    t0 = time.perf_counter()
    big_locus, big_data, big_names, big_reads, bg_big, rp_big = \
        build_100k_sample(np.random.default_rng(17))
    n_big = sum(BIG_READS[0] < r.size <= BIG_READS[1] for r in big_reads)
    check(n_big >= 8, f"sample (e): {n_big} reads of {BIG_READS[0] + 1:,} "
                      f"to {BIG_READS[1]:,} bases")
    print(f"sample (e): {len(big_reads)} reads, "
          f"{sum(r.size for r in big_reads):,} bases, {n_big} of them of "
          f"{BIG_READS[0] + 1:,} to {BIG_READS[1]:,} bases, longest "
          f"{max(r.size for r in big_reads):,}; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    f_loci, f_genome, f_reads, f_bg = build_panel_sample(
        np.random.default_rng(0))
    print(f"sample (f): {len(f_loci)} loci, {len(f_reads[0])} locus pairs "
          f"and {f_bg[0].shape[0]} background pairs built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    g_loci, g_genome, g_reads = build_hla_panel(np.random.default_rng(0))
    print(f"sample (g): {len(g_loci)} loci x {len(g_loci[0].haplotypes)} "
          f"haplotypes, {len(g_reads[0])} pairs built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    hw = build_paralog_sample(np.random.default_rng(0))
    iw = build_hifi_sample(np.random.default_rng(0))
    # Not seed 0: a fresh generator of seed 0 drew (h)'s ancestor, and its
    # first draws here would put a copy of the gene into the flank.
    kw = build_ont_paralog_sample(hw, np.random.default_rng(11))
    print(f"samples (h) and (i): one locus of {PARALOG_LOCUS:,} bp x "
          f"{len(hw['locus'].haplotypes)} haplotypes and its paralog at "
          f"{PARALOG_IDENTITY:.0%} identity, "
          + ", ".join(f"({k}) {len(r[0])} pairs"
                      for k, r in hw["reads"].items())
          + f"; one locus of {HIFI_LOCUS:,} bp x 4 haplotypes, "
          f"{len(iw['reads'][0])} HiFi-like reads; (k) one locus of "
          f"{kw['locus'].haplotypes[0].size:,} bp ((h)'s gene widened) on "
          f"{kw['genome'].size:,} bp, {len(kw['reads'][0])} ONT-like reads "
          f"of {sum(r.size for r in kw['reads'][1]):,} bases; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    bg, bg_long = make_bg(), make_bg_long()
    rp = RecruitParams(match_frac=Technology.ILLUMINA.default_match_frac(True))
    rp_long = RecruitParams(
        match_frac=Technology.NANOPORE.default_match_frac(False),
        match_length=2000)

    def long_iter():
        return ((n, r, None) for n, r in zip(long_names, long_reads))

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp_name, \
            Recorder() as rec:
        tmp = Path(tmp_name)
        t0 = time.perf_counter()
        fq1, fq2 = write_fastq_pair(tmp, *panel_reads)
        print(f"sample (a): {len(panel_reads[0])} pairs written to "
              f"{fq1.name}, {fq2.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)

        def run_a(seed=1):
            return run_main_path(
                "(a) panel 4 loci x 6 haplotypes, background x"
                f"{BACKGROUND_MULTIPLE}, FASTQ", panel_loci, panel_data,
                len(panel_reads[0]),
                lambda: G.recruit_reads_fast(panel_data, fq1, fq2, rp)[0],
                bg, 48, seed)

        def run_b(seed=2):
            return run_main_path(
                "(b) HLA-scale locus, 200 haplotypes", hla_loci, hla_data,
                len(hla_reads[0]),
                lambda: recruit_records(hla_data, zip(*hla_reads), rp)[0],
                bg, 48, seed)

        def run_c(seed=3):
            return run_main_path(
                "(c) long reads, 3 loci x 4 haplotypes of 16,384 bp",
                long_loci, long_data, len(long_names),
                lambda: recruit_records(long_data, long_iter(), rp_long)[0],
                bg_long, 160, seed)

        def run_cli():
            run_cli_path("(a') command line: add, genotype", tmp, panel_loci,
                         panel_genome, fq1, fq2)

        def run_seq():
            run_seq_cli("(a-seq) command line: genotype -S ...,e=seq", tmp,
                        panel_loci, fq1, fq2,
                        rec.greedy_iters.setdefault("a_seq", []))

        def run_e(seed=5):
            return run_main_path(
                "(e) long reads, one locus of 98,304 bp, reads up to "
                f"{max(r.size for r in big_reads):,} bases", [big_locus],
                big_data, len(big_reads),
                lambda: recruit_records(
                    big_data, ((n, r, None) for n, r in zip(big_names,
                                                            big_reads)),
                    rp_big)[0], bg_big, 160, seed)

        grid = M.make_mesh(devices=[torch.device("cuda", 0)] * GRID)

        def run_mesh():
            run_mesh_cli(f"(a-mesh) command line: genotype, {GRID} shards on "
                         "card 0", tmp, panel_loci, fq1, fq2, grid,
                         rec.recruited, "out_mesh")

        def run_mesh_cards():
            run_mesh_cli("(a-mesh) command line: genotype, the real "
                         "auto_mesh() over distinct cards", tmp, panel_loci,
                         fq1, fq2, None, rec.recruited, "out_mesh_cards")

        def run_batched():
            run_batched_cli("(a-batched) command line: genotype -S "
                            "...,e=batched", tmp, panel_loci, fq1, fq2)

        b_mesh = {}

        def run_b_mesh(seed=2):
            with MeshCapture() as cap:
                b_mesh["cap"] = cap
                return run_main_path(
                    f"(b-mesh) HLA-scale locus, 200 haplotypes, {GRID} shards "
                    "on card 0", hla_loci, hla_data, len(hla_reads[0]),
                    lambda: recruit_records(hla_data, zip(*hla_reads),
                                            rp)[0], bg, 48, seed, mesh=grid,
                    keep=b_mesh)

        wgs = {}

        def run_d():
            (tmp / "d").mkdir()
            wgs.update(run_wgs_path(
                "(d) WGS-like, command line: add, preproc, genotype",
                tmp / "d", panel_loci, np.random.default_rng(4)))

        def run_j():
            run_j_path("(j) (d)'s sample as an indexed CRAM: preproc -a, "
                       "genotype -i wgs.cram -r ref.fa", tmp / "d", wgs, rec,
                       rp)

        def run_option(key):
            return lambda: run_option_cli(key, tmp, panel_loci, fq1, fq2, rec)

        panel_f = {}

        def run_f():
            (tmp / "f").mkdir()
            t0 = time.perf_counter()
            panel_f["fq"] = write_panel_fastq(tmp / "f", f_reads, f_bg)
            print(f"sample (f): {len(f_reads[0]) + f_bg[0].shape[0]} pairs "
                  f"written to two gzip FASTQ files in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            db, n_keys, argv, _ = run_panel_path(
                f"(f) panel {len(f_loci)} loci x 6 haplotypes, command line: "
                "add, genotype", tmp / "f", f_loci, f_genome,
                *panel_f["fq"], "out_f", saved_at=rec.saved_at)
            panel_f.update(db=db, n_keys=n_keys, argv=argv)

        panel_g = {}

        def run_g():
            (tmp / "g").mkdir()
            fq = write_fastq_pair(tmp / "g", *g_reads)
            db, n_keys, argv, calls = run_panel_path(
                f"(g) HLA-scale panel, {len(g_loci)} loci x "
                f"{len(g_loci[0].haplotypes)} haplotypes, command line: add, "
                "genotype", tmp / "g", g_loci, g_genome, *fq, "out_g",
                saved_at=rec.saved_at)
            panel_g.update(db=db, n_keys=n_keys, argv=argv, calls=calls)

        def run_g_2proc():
            panel_g["launches"] = run_processes(
                f"(g-2proc) (g)'s genotype as {WORLD} processes on the card",
                tmp / "g", g_loci, panel_g["argv"], "out_g2proc",
                panel_g["calls"])

        paths_run = [("a", run_a), ("a_cli", run_cli), ("a_seq", run_seq),
                     ("a-m16", run_option("a-m16")),
                     ("a-priors", run_option("a-priors")),
                     ("a-knobs", run_option("a-knobs")),
                     ("a-profile", lambda: run_profile_cli(
                         tmp, panel_loci, fq1, fq2)),
                     ("a_mesh", run_mesh), ("a_batched", run_batched),
                     ("b", run_b), ("b_mesh", run_b_mesh), ("c", run_c),
                     ("d", run_d), ("j", run_j), ("f", run_f),
                     ("g", run_g),
                     ("g_2proc", run_g_2proc),
                     ("h", lambda: run_h_path(tmp / "h", hw, rec)),
                     ("h-P3", lambda: run_h_ploidy_path(
                         "h-P3", 3, tmp / "h", hw, rec)),
                     ("h-P1", lambda: run_h_ploidy_path(
                         "h-P1", 1, tmp / "h", hw, rec)),
                     ("h-w", lambda: run_h_w_path(tmp / "h", hw)),
                     ("i", lambda: run_hifi_path(tmp / "i", iw, rec)),
                     ("k", lambda: run_k_path("k", tmp / "k", kw, rec)),
                     ("k-bam", lambda: run_k_path("k-bam", tmp / "k", kw,
                                                  rec)),
                     ("e", run_e)]
        if cards_grid is not None:
            paths_run.insert(4, ("a_mesh_cards", run_mesh_cards))
        recruited = {}
        for key, run in paths_run:
            rec.path = key
            _kernels.reset_launches()
            recruited[key] = run()
            launches[key] = dict(_kernels.LAUNCHES)
            if key == "g_2proc":
                # The processes' own counts; this one launched nothing.
                check(not any(launches[key].values()),
                      f"(g-2proc) launched {launches[key]} in this process")
                for rank, counts in enumerate(panel_g["launches"]):
                    for name in NEEDS[key]:
                        check(counts[name] > 0, f"kernel {name} was never "
                              f"launched by process {rank} of ({key})")
                launches[key] = {name: sum(c[name]
                                           for c in panel_g["launches"])
                                 for name in launches[key]}
            for name in NEEDS[key]:
                check(launches[key][name] > 0, f"kernel {name} was never "
                      f"launched by main path ({key})")
            for name in NEVER.get(key, ()):
                check(launches[key][name] == 0, f"kernel {name} was launched "
                      f"{launches[key][name]} times by main path ({key})")
        check(rec.n_align_long.get("c", 0) > 0, "main path (c) launched "
              f"align_banded on no rows longer than {LONG_ROWS}")
        check_against_host("(a)", panel_data, recruited["a"],
                           zip(*panel_reads), rp)
        check_against_host("(b)", hla_data, recruited["b"], zip(*hla_reads),
                           rp)
        check_against_host("(c)", long_data, recruited["c"], long_iter(),
                           rp_long, ordered=False)
        check(rec.n_align_long.get("e", 0) > 0, "main path (e) launched "
              f"align_banded on no rows longer than {LONG_ROWS}")
        check({k: v[1] for k, v in recruited["b_mesh"].items()}
              == {k: v[1] for k, v in recruited["b"].items()},
              "(b-mesh) recruited other reads than (b)")
        f_data = check_panel_index("(f)", panel_f["db"],
                                   [lc.name for lc in f_loci], rp,
                                   panel_f["n_keys"])
        first = list(first_pairs(f_reads, f_bg, PANEL_HOST_PAIRS))
        keep = {name for name, _, _ in first}
        check_against_host(
            f"(f), first {len(first):,} pairs", f_data,
            {n: (None, [x for x in v if x in keep])
             for n, v in rec.recruited["out_f"].items()}, iter(first), rp)
        g_data = check_panel_index("(g)", panel_g["db"],
                                   [lc.name for lc in g_loci], rp,
                                   panel_g["n_keys"])
        check_against_host(
            f"(g), all {len(g_reads[0]):,} pairs", g_data,
            {n: (None, v) for n, v in rec.recruited["out_g"].items()},
            zip(*g_reads), rp)
        check_h_i_recruitment(hw, iw, rec, rp)
        check_k_recruitment(kw, rec, rp_long)

        if want_profile:
            profile_main_path("(b) HLA-scale locus, traced",
                              lambda: run_b(seed=3))
            profile_main_path("(a) panel from FASTQ, traced",
                              lambda: run_a(seed=3))
            profile_main_path(
                "(a) recruit phase alone, traced",
                lambda: G.recruit_reads_fast(panel_data, fq1, fq2, rp))
            profile_main_path(
                "(c) recruit phase alone, traced",
                lambda: recruit_records(long_data, long_iter(), rp_long))
            profile_main_path("(d) preproc, traced",
                              lambda: check(cli.main(wgs["preproc"]) == 0,
                                            "(d) preproc, traced"))
            profile_host("(d) preproc, host functions",
                         lambda: check(cli.main(wgs["preproc"]) == 0,
                                       "(d) preproc, host functions"))
            profile_main_path("(f) genotype, traced",
                              lambda: check(cli.main(panel_f["argv"]) == 0,
                                            "(f) genotype, traced"))

    # Outside the recorder: these launches compare, they are no main path.
    check_b_mesh("(b-mesh)", grid, b_mesh["cap"], b_mesh["built"])
    reads, lens, wins, svec, band = rec.align
    k1 = compare_align(reads, lens, wins, svec, band, "main-path launch")
    print(f"main-path launch of align_banded {k1['shape']} [N, L, band]: "
          f"all 8 outputs bit-identical; {k1['ms']:.3f} ms (earlier design "
          f"{EARLIER_MS['align_banded']} ms; "
          f"plain {k1['plain_ms']:.0f} ms, bound {k1['bound_ms']:.4f} ms "
          f"by {k1['bound_by']})", flush=True)
    reads, lens, wins, svec, band = rec.align_long
    k4 = compare_align(reads, lens, wins, svec, band,
                       "main-path launch on long rows")
    check(k4["shape"][1] > LONG_ROWS, f"long rows: L = {k4['shape'][1]}")
    print(f"main-path launch of align_banded on long rows {k4['shape']} "
          f"[N, L, band], longest read {int(lens.max())}: all 8 outputs "
          f"bit-identical; {k4['ms']:.3f} ms (earlier design "
          f"{EARLIER_MS['align_banded_long_rows']} ms; plain "
          f"{k4['plain_ms']:.0f} ms, "
          f"bound {k4['bound_ms']:.4f} ms by {k4['bound_by']})", flush=True)
    # (e): K1 at band 160 and K5 on the widest launches of the 100 kb
    # sample, at most 8 jobs or rows of each.
    reads, lens, wins, svec, band = rec.widest[("e", "align")]
    pick = longest_jobs(lens, BIG_READS[0])
    check(band == 160 and pick.numel() > 0,
          f"(e): widest launch at band {band}, {pick.numel()} jobs with reads "
          f"longer than {BIG_READS[0]:,}")
    n_rows = int(lens[pick].max())
    k1e = compare_align(reads[pick], lens[pick], wins[pick], svec, band,
                        "(e) widest launch")
    whole_ms = time_ms(lambda: A.align_banded(reads, lens, wins, svec, band))
    whole_bound, whole_by = align_bound_ms(reads, lens, wins, band)
    print(f"(e) widest launch of align_banded {list(reads.shape)} [N, L], "
          f"band {band}, longest read {int(lens.max()):,}: "
          f"{whole_ms:.3f} ms (bound {whole_bound:.4f} ms by {whole_by}); "
          f"{pick.numel()} of its jobs with reads of "
          f"{int(lens[pick].min()):,} to {n_rows:,} bases: all 8 outputs "
          f"bit-identical (largest n_clip {int(k1e['got']['n_clip'].max()):,},"
          f" end {int(k1e['got']['end_p'].max()):,}), {k1e['ms']:.3f} ms "
          f"(plain {k1e['plain_ms']:.0f} ms, bound {k1e['bound_ms']:.4f} ms "
          f"by {k1e['bound_by']})", flush=True)
    reads, k5e = hold_widest_front(rec, "e")
    check(reads.shape[1] > BIG_READS[0], "(e): widest full-width front-end "
          f"launch at L = {reads.shape[1]}")
    largest = rec.largest_anneal()
    check(set(largest) == {"anneal", "polish"},
          f"annealer modes on the main path: {sorted(largest)}")
    k2_modes = {}
    for mode, (args, kw, _) in largest.items():
        m = compare_anneal(args, kw, f"main-path {mode} launch", timed=True)
        k2_modes[mode] = m
        print(f"main-path {mode} launch of anneal_chains {m['shape']}: "
              f"equals plain exactly; {m['moves']} moves proposed of "
              f"{m['shape']['C'] * m['shape']['n_steps']}, "
              f"{m['rounds_per_batch']:.2f} evaluation rounds a batch of 32 "
              f"steps; {m['ms']:.3f} ms (earlier design "
              f"{EARLIER_MS['anneal_chains_' + mode]} ms on "
              f"{EARLIER_CHAINS[mode]:,} chains), "
              f"{m['moves'] / m['ms'] * 1e3:.3e} moves/s "
              f"(plain {m['plain_ms']:.0f} ms, bound {m['bound_ms']:.4f} ms "
              f"by {m['bound_by']})", flush=True)

    k2_ploidy = hold_ploidy_launches(rec)
    k1i = hold_long_launches(rec, "i")
    held_k = hold_ont_launches(rec)

    def launch_size(mode):
        shape = k2_modes[mode]["shape"]
        return shape["C"] * shape["R"] * shape["K"] * shape["n_steps"]

    k2_mode = max(k2_modes, key=launch_size)
    k2 = k2_modes[k2_mode]
    check(set(rec.front) == {"compact", "full", "compact_k16"},
          f"minimizer_front entries on the main path: {sorted(rec.front)}")
    k3 = {}
    for entry in ("compact", "full"):
        reads, k, w, S = rec.front[entry]
        m = compare_front(reads, k, w, S, f"main-path {entry} launch")
        k3[entry] = m
        print(f"main-path launch of minimizer_front ({entry}) {m['shape']}: "
              f"all outputs bit-identical; {m['ms']:.4f} ms (earlier design "
              f"{EARLIER_MS['minimizer_front_' + entry]} ms; "
              f"plain {m['plain_ms']:.0f} ms, bound {m['bound_ms']:.4f} ms "
              f"by {m['bound_by']})", flush=True)
    # (a-m16): the compacting entry at k = 16, on its largest launch.
    reads, k, w, S = rec.front["compact_k16"]
    k3_16 = compare_front(reads, k, w, S, "(a-m16) largest k = 16 launch")
    n_k16 = rec.n_front_k["compact_k16"]
    print(f"(a-m16) largest launch of minimizer_front (compact) at k = 16 "
          f"{k3_16['shape']}, {n_k16} launches at k = 16: all outputs "
          f"bit-identical; {k3_16['ms']:.4f} ms (plain "
          f"{k3_16['plain_ms']:.0f} ms, bound {k3_16['bound_ms']:.4f} ms by "
          f"{k3_16['bound_by']})", flush=True)

    def numbers(m):
        return {k: m[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "shape")}

    def entry(name, counters, source, replaces, m, **more):
        """One kernel (or one of its entries) with every key of the line;
        `counters` are the launch counters that belong to it."""
        by_path = {key: sum(launches[key][c] for c in counters)
                   for key in launches}
        return dict(name=name, route="cuda",
                    source=f"locityper_tpu_torch/ops/csrc/{source}",
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path, **numbers(m), library_ms=None,
                    **more)

    long_rows = entry("align_banded", ["align_banded"], "align_banded.cu",
                      "locityper_tpu/ops/align_pallas.py:301", k4,
                      rows_over_65536=numbers(k1e),
                      hifi_preproc=numbers(k1i["i-preproc"]),
                      hifi_genotype=numbers(k1i["i"]),
                      ont_preproc=numbers(held_k["align_k-preproc"]),
                      ont_genotype=numbers(held_k["align_k"]))
    long_rows["launches_by_path"] = {key: rec.n_align_long.get(key, 0)
                                     for key in launches}
    long_rows["launches"] = sum(long_rows["launches_by_path"].values())
    print(json.dumps({"kernels": [
        entry("align_banded", ["align_banded"], "align_banded.cu",
              "locityper_tpu/ops/align_pallas.py:370", k1,
              long_rows=long_rows),
        entry("anneal_chains", ["anneal_chains"], "anneal_chains.cu",
              "locityper_tpu/ops/solver_pallas.py:381", k2,
              rounds_per_batch=k2["rounds_per_batch"],
              modes={mode: dict(
                  numbers(m), moves=m["moves"],
                  rounds_per_batch=m["rounds_per_batch"],
                  **({"whole_ms": m["whole_ms"]}
                     if m.get("whole_ms") is not None else {}))
                  for mode, m in {**k2_modes, **k2_ploidy,
                                  "polish_k": held_k["polish_k"],
                                  "anneal_k": held_k["anneal_k"]}.items()}),
        entry("minimizer_front", FRONT, "minimizer_front.cu",
              "locityper_tpu/ops/recruit.py:358", k3["compact"],
              entries={
                  "compact": entry(FRONT[0], FRONT[:1], "minimizer_front.cu",
                                   "locityper_tpu/ops/recruit.py:358",
                                   k3["compact"],
                                   k16=dict(numbers(k3_16),
                                            launches=n_k16)),
                  "full": entry(FRONT[1], FRONT[1:], "minimizer_front.cu",
                                "locityper_tpu/ops/recruit.py:316",
                                k3["full"], rows_of_131072=numbers(k5e),
                                ont_preproc=numbers(
                                    held_k["full_k-preproc"]),
                                ont_genotype=numbers(held_k["full_k"]))})]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
