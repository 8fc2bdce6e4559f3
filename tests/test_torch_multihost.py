"""Loci split across processes (`parallel/multihost.py`) against the JAX
package's, and two REAL gloo processes genotyping one panel.

`lpt_assign` and the per-locus cost proxy `_locus_cost_estimate` equal the
JAX package's on the same inputs.  Then the world of tests/test_multihost.py
(4 loci × 4 haplotypes, seed 31; the port's own `add` and `preproc`) is
genotyped by two processes of the port's command line on the CPU, joined
through the environment that `torchrun` sets (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK): each takes 2 of the 4 loci, and the shared output
directory calls all four.
"""
import gzip
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from locityper_tpu.commands.genotype import \
    _locus_cost_estimate as j_cost_estimate
from locityper_tpu.parallel.multihost import lpt_assign as j_lpt_assign
from locityper_tpu_torch import cli, sim
from locityper_tpu_torch.commands.genotype import _locus_cost_estimate
from locityper_tpu_torch.parallel.multihost import (lpt_assign,
                                                    maybe_init_distributed,
                                                    shard_loci)
from locityper_tpu_torch.seq import fastx
from locityper_tpu_torch.utils.io import smart_create

ROOT = Path(__file__).resolve().parent.parent
N_LOCI = 4

_WORKER = r"""
import sys
import torch
torch.set_num_threads(2)
import torch.distributed as dist
from locityper_tpu_torch import cli
rc = cli.main(sys.argv[1:])
assert dist.is_initialized() and dist.get_world_size() == 2
sys.exit(rc)
"""


@pytest.mark.parametrize("costs,n_bins", [
    ([5.0, 3.0, 3.0, 1.0], 2),
    ([1.0] * 7, 3),
    ([10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 9.0], 2),
    (list(np.random.default_rng(3).uniform(0.1, 50.0, 40)), 4),
    ([2.5], 4),
])
def test_lpt_assign_equals_reference(costs, n_bins):
    got = lpt_assign(costs, n_bins)
    assert got == j_lpt_assign(costs, n_bins)
    loads = np.bincount(got, weights=costs, minlength=n_bins)
    # The LPT bound against the largest item and the mean load.
    assert loads.max() <= max(max(costs), sum(costs) / n_bins) * 4 / 3 + 1e-9


def test_single_process_takes_every_locus():
    assert not maybe_init_distributed()
    names = ["a", "b", "c"]
    assert shard_loci(names) == names
    assert shard_loci(names, [1.0, 2.0, 3.0]) == names


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_multihost.py's world, written by the port's `add` and
    `preproc` on the CPU."""
    root = tmp_path_factory.mktemp("mh_torch")
    rng = np.random.default_rng(31)
    loci = [sim.simulate_locus(rng, f"G{i}", length=2500, n_haps=4,
                               divergence=0.02) for i in range(N_LOCI)]
    parts = [sim.random_genome(rng, 15000)]
    starts = []
    for locus in loci:
        starts.append(sum(p.size for p in parts))
        parts.append(locus.haplotypes[0])
        parts.append(sim.random_genome(rng, 15000))
    genome = np.concatenate(parts)
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    bed = "".join(f"chr1\t{s}\t{s + loci[i].haplotypes[0].size}\tG{i}\n"
                  for i, s in enumerate(starts))
    (root / "loci.bed").write_text(bed)
    for locus in loci:
        with open(root / f"haps_{locus.name}.fa", "w") as f:
            for name, seq in zip(locus.hap_names, locus.haplotypes):
                fastx.write_fasta(f, name, seq)
    assert cli.main(["--device", "cpu", "add", "-d", str(root / "db"),
                     "-r", str(root / "ref.fa"), "-l", str(root / "loci.bed"),
                     "-s", str(root / "haps_{}.fa")]) == 0
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    all1, all2, names = [], [], []
    for locus in loci:
        r = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=18.0, errors=err, prefix=locus.name)
        all1 += r.reads1
        all2 += r.reads2
        names += r.names
    flanks = [p for p in parts if p.size == 15000]
    bgr = sim.simulate_paired_reads(rng, flanks, depth=8.0, errors=err,
                                    prefix="bg")
    all1 += bgr.reads1
    all2 += bgr.reads2
    names += bgr.names
    with smart_create(root / "r1.fq.gz") as f1, \
            smart_create(root / "r2.fq.gz") as f2:
        for nm, a, b in zip(names, all1, all2):
            fastx.write_fastq(f1, fastx.Read(nm, a))
            fastx.write_fastq(f2, fastx.Read(nm, b))
    assert cli.main(["--device", "cpu", "preproc", "-i",
                     str(root / "r1.fq.gz"), str(root / "r2.fq.gz"),
                     "-r", str(root / "ref.fa"), "-o", str(root / "bg"),
                     "-b", f"chr1:1001-{genome.size - 1000}"]) == 0
    return root, loci


def test_locus_cost_estimate_equals_reference(world):
    root, loci = world
    db = root / "db"
    costs = [_locus_cost_estimate(db, lc.name) for lc in loci]
    assert costs == [j_cost_estimate(db, lc.name) for lc in loci]
    assert all(c > 1.0 for c in costs)
    assert _locus_cost_estimate(db, "missing") == 1.0


def test_two_gloo_processes_split_the_loci(world):
    root, loci = world
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = root / "out"
    worker = root / "worker.py"
    worker.write_text(_WORKER)
    args = [sys.executable, str(worker), "--device", "cpu", "genotype",
            "-i", str(root / "r1.fq.gz"), str(root / "r2.fq.gz"),
            "-d", str(root / "db"), "-p", str(root / "bg"),
            "-o", str(out), "-S", "anneal:i=6,a=6,n=2500,p=1200",
            "--seed", "4"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]

    # Cost-weighted LPT over near-equal costs balances 2/2, and the halves
    # partition the panel: every locus genotyped by exactly one process.
    logs = [se for _, se in outs]
    for rank in range(2):
        assert any(f"Host {rank}/2 takes 2/4 loci" in se for se in logs)
    done = [{f"G{i}" for i in range(N_LOCI) if f"[G{i}] GT =" in se}
            for se in logs]
    assert len(done[0]) == len(done[1]) == 2, (done, logs[0][-2000:])
    assert done[0] | done[1] == {f"G{i}" for i in range(N_LOCI)}
    assert not done[0] & done[1]
    for i, locus in enumerate(loci):
        res_path = out / "loci" / f"G{i}" / "res.json.gz"
        assert res_path.exists(), f"G{i} missing from the merged output"
        res = json.load(gzip.open(res_path))
        called = sorted(res["genotype"].split(","))
        truth = sorted(locus.hap_names[j] for j in locus.true_genotype)
        assert called == truth, (i, called, truth)
