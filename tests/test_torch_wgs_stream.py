"""A whole-genome FASTQ stream through the port's recruitment on the CPU:
`panel6_sr` (bench_port/configs) cut to 2 loci of 6 haplotypes between
flanks of 30 kb read at 30x, about 9,000 off-target pairs behind 800 locus
pairs.  `recruit_reads_fast` recruits exactly the pairs that the
benchmark's plain reference recruits, at the main path's batch and at a
small one, with parse chunks that cut across batches; `genotype` calls the
truth, and its counters and the reader threads' spans add up."""
import gzip
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_port import check, gen, reference
from bench_port.run import Cell
from locityper_tpu_torch import cli as tcli
from locityper_tpu_torch.commands import genotype as TG
from locityper_tpu_torch.seq import fastx
from locityper_tpu_torch.seq.recruit import RecruitParams
from locityper_tpu_torch.utils import spans

torch.set_num_threads(1)        # the suite runs several workers side by side

BENCH = Path(gen.__file__).resolve().parent
#: bench_port/tests/test_run_cpu.py's scheme: the plain annealer in seconds.
SHORT = ["-S", "greedy:i=5k,a=1,p=500", "anneal:i=20,a=20,n=1k,p=500"]
SEED = 2**40 + 24


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = json.loads((BENCH / "configs/panel6_sr.json").read_text())
    cfg["panel"].update(n_loci=2, n_clades=3, haps_per_clade=2)
    cfg["flank_len"] = 30_000
    traffic = json.loads((BENCH / "traffic/wgs_bg.json").read_text())
    assert traffic["flank_multiple"] == 2
    traffic["samples"] = 1
    cell = Cell(SimpleNamespace(config=cfg, traffic=traffic), SEED,
                tmp_path_factory.mktemp("wgs"),
                device_args=["--device", "cpu"])
    cell.draw()
    cell.add()
    index = reference.RecruitIndex(cell.loci, cell.genome, cell.starts,
                                   torch.device("cpu"))
    smp = cell.samples[0]
    cell.expected = reference.recruit(index, smp.names, smp.mates1,
                                      smp.mates2, cell.flank)
    cell.n_pairs = len(smp.names) + len(cell.flank[0])
    return cell


def test_the_stream_is_mostly_off_target(world):
    assert 8_000 < len(world.flank[0]) < 10_000
    assert len(world.flank[0]) > 10 * len(world.samples[0].names)
    assert all(len(v) > 300 for v in world.expected.values())


@pytest.mark.parametrize("chunk", [None, 64 * 1024])
@pytest.mark.parametrize("batch", [1024, 32768])
def test_fast_recruitment_equals_the_reference(world, batch, chunk,
                                               monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(fastx, "_CHUNK_BYTES", chunk)
    loci = {lc.name: TG.load_locus(world.db, lc.name) for lc in world.loci}
    stats = {}
    got, _ = TG.recruit_reads_fast(loci, *world.fastq[0], RecruitParams(),
                                   batch=batch, stats=stats, device="cpu")
    assert stats["records"] == world.n_pairs
    for name, want in world.expected.items():
        assert set(got[name][1]) == want, name


def test_genotype_calls_the_truth_and_counts_the_stream(world):
    out = world.work / "out_cli"
    rc = tcli.main(["--device", "cpu", *world.genotype_args(0, out), *SHORT])
    assert rc == 0
    assert check.wrong_call_share([(out, 0)], world.loci,
                                  world.samples) == 0
    kept = spans.snapshot()
    root = next(s for s in reversed(kept)
                if s.name == "genotype" and s.parent is None)
    counters = root.attrs
    assert counters["pairs_parsed"] == world.n_pairs
    assert counters["k3_rows"] == 2 * counters["pairs_parsed"]
    assert counters["fastq_bytes"] == sum(
        len(gzip.decompress(Path(p).read_bytes())) for p in world.fastq[0])
    mine = [s for s in kept if s.call == root.id]
    (layer,) = [s for s in mine if s.name == "recruit"]
    reads = [s for s in mine if s.name == "recruit.read"]
    assert reads and sum(s.attrs["pairs"] for s in reads) \
        == counters["pairs_parsed"]
    mates = {m: [s for s in mine if s.name == "recruit.mate"
                 and s.attrs["mate"] == m] for m in (1, 2)}
    for m, chunks in mates.items():
        assert sum(s.attrs["records"] for s in chunks) \
            == counters["pairs_parsed"], m
    # One thread a mate file, and one more that pairs their blocks.
    threads = {m: {s.thread for s in chunks} for m, chunks in mates.items()}
    assert len(threads[1]) == len(threads[2]) == 1
    assert len(threads[1] | threads[2] | {root.thread}) == 3
    assert {s.thread for s in reads}.isdisjoint(
        threads[1] | threads[2] | {root.thread})
    for s in reads + mates[1] + mates[2]:
        assert s.parent is layer
        assert layer.start <= s.start <= s.end <= layer.end
    # Names are decoded for the recruited rows alone: once a locus a pair.
    assert counters["pairs_recruited"] <= counters["names_decoded"] \
        <= 2 * counters["pairs_recruited"]
    assert 5 * counters["names_decoded"] < counters["pairs_parsed"]
    line = spans.summary(root)
    for part in ("read ", "mate ", "k3_rows=", "fastq_bytes=",
                 "names_decoded="):
        assert part in line, part
