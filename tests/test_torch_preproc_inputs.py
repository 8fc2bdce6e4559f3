"""`preproc` of the port against the JAX package's: the options that choose
which reads the estimation sees.

The world of tests/test_torch_preproc.py (400 kb, 24x, reads in genome
order).  Each case runs both packages' `preproc` on the same files, the port
with `--device cpu`, and compares `distr.json.gz`: integers and strings
exactly, floats within the relative 1e-9 of that file.  `--max-reads` and
`--subsample` draw with numpy's `default_rng(0)` and `default_rng(--seed)` in
both packages, so both estimate from the same reads.
"""
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from locityper_tpu.seq import bai as jbai
from locityper_tpu.seq import bam as jbam
from locityper_tpu.seq import fastx

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_preproc import (REGION, assert_same_json,  # noqa: E402
                                make_world, run_both)

torch.set_num_threads(1)        # the suite runs several workers side by side


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("torchpre_in"))


@pytest.mark.parametrize("name,extra", [
    ("max_reads", ["--max-reads", "1500"]),
    ("subsample", ["--subsample", "0.1", "--seed", "3"]),
])
def test_read_selection_equal(world, name, extra):
    j_json, t_json = run_both(world, name, "-b", REGION, *extra)
    assert_same_json(j_json, t_json)
    # The recruitment stream counted the input's pairs.
    assert t_json["seq_info"]["total_reads"] == len(world.reads.names)


def test_skip_recruitment_equal(world):
    """`--skip-recruitment` takes the first `--max-reads` pairs of an input
    that is already restricted to the background region, and aligns them
    to the region without its padding: here the pairs drawn from the
    region, in the order of the world's files."""
    rd, (lo, hi) = world.reads, (170_000, 230_000)
    r1, r2 = world.root / "region_1.fq", world.root / "region_2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for name, pos, c1, c2 in zip(rd.names, rd.source_pos, rd.reads1,
                                     rd.reads2):
            if lo <= pos < hi - 400:
                fastx.write_fastq(f1, fastx.Read(name, c1))
                fastx.write_fastq(f2, fastx.Read(name, c2))
    j_json, t_json = run_both(world, "skip", "-b", REGION,
                              "--skip-recruitment", "--max-reads", "1500",
                              inputs=["-i", r1, r2])
    assert_same_json(j_json, t_json)
    # No stream over the whole input, so no read count.
    assert t_json["seq_info"]["total_reads"] is None


def test_indexed_bam_input(world, caplog):
    """`-a` with a coordinate-sorted, indexed BAM: the background region is
    fetched through the index instead of scanning the input
    (preproc.rs:1180-1202), in both packages."""
    rd = world.reads
    flat = []
    for name, pos, c1, c2 in zip(rd.names, rd.source_pos, rd.reads1,
                                 rd.reads2):
        flat.append((pos, name, jbam.FLAG_PAIRED | jbam.FLAG_MATE1, c1))
        flat.append((pos + 250, name, jbam.FLAG_PAIRED | jbam.FLAG_MATE2,
                     c2))
    flat.sort(key=lambda t: t[0])
    bam_path = world.root / "sample.bam"
    with jbam.BamWriter(bam_path, ["chr1"], [world.genome.size]) as w:
        for pos, name, flag, codes in flat:
            w.write(name, flag, codes, ref_id=0, pos=pos)
    jbai.build_bai(bam_path)
    with caplog.at_level(logging.INFO, logger="locityper"):
        j_json, t_json = run_both(world, "indexed", "-b", REGION,
                                  "--max-reads", "1500",
                                  inputs=["-a", bam_path])
    fetched = [r.message for r in caplog.records
               if r.message.startswith("Indexed input")]
    assert len(fetched) == 2 and fetched[0] == fetched[1], fetched
    assert_same_json(j_json, t_json)
    assert t_json["seq_info"]["total_reads"] is None
    mean = t_json["insert_distr"]
    assert np.isfinite(mean["n"]) and np.isfinite(mean["p"])
