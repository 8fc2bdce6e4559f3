"""The port's span recorder (`locityper_tpu_torch/utils/spans.py`) on its
own: what a span keeps, its bounds, threads and counters.  A whole
`genotype` call's spans are held in tests/test_torch_genotype_cmd.py.

Last, one counter of whole calls, `compl_haps`: each locus's neighbourhood
profile (`model/windows.py:NeighbProfile`) is built once a call, by
post-alignment for short reads and by the solver's inputs for long reads,
and again in the next call.  A small world of two loci goes through the
port's own `add`, `preproc` and `genotype` on the CPU, no file of the JAX
package's."""
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from locityper_tpu_torch import cli as tcli
from locityper_tpu_torch import sim
from locityper_tpu_torch.model.windows import NeighbProfile
from locityper_tpu_torch.seq import fastx
from locityper_tpu_torch.utils import spans
from locityper_tpu_torch.utils.io import smart_create
from locityper_tpu_torch.utils.spans import Recorder, summary

torch.set_num_threads(1)        # the suite runs several workers side by side


def test_a_span_that_raises_is_closed_and_leaves_the_stack_clean():
    rec = Recorder()
    with rec.call("genotype") as root:
        with pytest.raises(ValueError):
            with rec.span("solve"):
                with rec.span("solve.stage1", chunks=2):
                    raise ValueError("inside a step")
        assert rec.current() is root
    assert rec.current() is None
    stage, layer, call = rec.snapshot()
    assert (stage.name, layer.name, call.name) == ("solve.stage1", "solve",
                                                   "genotype")
    assert stage.parent is layer and layer.parent is call
    assert call.start <= layer.start <= stage.start <= stage.end \
        <= layer.end <= call.end
    assert stage.attrs == {"chunks": 2}
    assert {s.call for s in (stage, layer, call)} == {call.id}


def test_a_call_that_raises_is_closed_and_ends_the_call():
    rec = Recorder()
    with pytest.raises(RuntimeError):
        with rec.call("genotype"):
            rec.count("k1_jobs", 3)
            raise RuntimeError("inside the call")
    (call,) = rec.snapshot()
    assert call.end is not None and call.attrs == {"k1_jobs": 3}
    rec.count("k1_jobs", 1)             # no call open: dropped
    with rec.span("recruit") as outside:
        pass
    assert outside.seconds >= 0 and rec.snapshot() == [call]


def test_the_deque_keeps_the_newest_spans_up_to_its_bound():
    rec = Recorder(maxlen=8)
    with rec.call("genotype"):
        for i in range(20):
            with rec.span("align.post", i=i):
                pass
    kept = rec.snapshot()
    assert len(kept) == 8
    assert [s.attrs["i"] for s in kept[:-1]] == list(range(13, 20))
    assert kept[-1].name == "genotype"


def test_a_worker_thread_names_its_parent():
    rec = Recorder()
    with rec.call("genotype") as root:
        with rec.span("align") as layer:
            def work():
                with rec.span("align.vote", parent=layer):
                    pass
                with rec.span("align.orphan"):
                    pass
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by_name = {s.name: s for s in rec.snapshot()}
    vote, orphan = by_name["align.vote"], by_name["align.orphan"]
    assert vote.parent is layer and vote.call == root.id
    assert orphan.parent is None and orphan.call == root.id
    assert vote.thread != root.thread == layer.thread


def test_counters_from_many_threads_lose_no_update():
    rec = Recorder()
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rec.call("genotype") as root:
            def add():
                for _ in range(n_adds):
                    rec.count("k2_chains", 1)
            threads = [threading.Thread(target=add)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert root.attrs["k2_chains"] == n_threads * n_adds


def test_the_summary_line_gives_layers_steps_and_counters():
    rec = Recorder()
    with rec.call("genotype") as root:
        with rec.span("entry.load"):
            pass
        with rec.span("recruit"):
            with rec.span("recruit.index"):
                pass
        rec.count("pairs_parsed", 10)
    line = summary(root, rec.snapshot())
    assert line.startswith(f"genotype call {root.id}: ")
    assert "entry " in line and "(load " in line
    assert "recruit " in line and "(index " in line
    assert line.endswith("pairs_parsed=10")
    assert "align" not in line


# --- the neighbourhood profile, once a call -------------------------------

LIGHT = ["-S", "greedy:i=5k,a=1", "anneal:i=4,a=4,n=1000,p=500"]


def torch_cli(*argv):
    return tcli.main(["--device", "cpu", *map(str, argv)])


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    """Two 3 kb loci of 3 and 4 haplotypes in a 146 kb genome; 150 bp pairs
    and 600 bp single reads of the true genotypes plus background; the
    port's database and one `preproc` directory for each kind of reads."""
    root = tmp_path_factory.mktemp("profile")
    rng = np.random.default_rng(21)
    loci = [sim.simulate_locus(rng, name, length=3000, n_haps=nh,
                               divergence=0.015)
            for name, nh in (("GA", 3), ("GB", 4))]
    flanks = [sim.random_genome(rng, n) for n in (60_000, 20_000, 60_000)]
    genome = np.concatenate([flanks[0], loci[0].haplotypes[0], flanks[1],
                             loci[1].haplotypes[0], flanks[2]])
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    s1 = flanks[0].size
    s2 = s1 + loci[0].haplotypes[0].size + flanks[1].size
    (root / "loci.bed").write_text(
        f"chr1\t{s1}\t{s1 + loci[0].haplotypes[0].size}\tGA\n"
        f"chr1\t{s2}\t{s2 + loci[1].haplotypes[0].size}\tGB\n")
    for lc in loci:
        with open(root / f"haps_{lc.name}.fa", "w") as f:
            for name, seq in zip(lc.hap_names, lc.haplotypes):
                fastx.write_fasta(f, name, seq)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    pairs = [sim.simulate_paired_reads(
        rng, [lc.haplotypes[i] for i in lc.true_genotype], depth=5.0,
        errors=err, prefix=lc.name) for lc in loci]
    pairs.append(sim.simulate_paired_reads(rng, [genome], depth=3.0,
                                           errors=err, prefix="bg"))
    r1, r2 = root / "r1.fq.gz", root / "r2.fq.gz"
    with smart_create(r1) as f1, smart_create(r2) as f2:
        for p in pairs:
            for name, a, b in zip(p.names, p.reads1, p.reads2):
                fastx.write_fastq(f1, fastx.Read(name, a))
                fastx.write_fastq(f2, fastx.Read(name, b))
    lerr = sim.ErrorModel(mismatch=0.003, insertion=0.002, deletion=0.002)
    singles = [sim.simulate_single_reads(
        rng, [lc.haplotypes[i] for i in lc.true_genotype], depth=3.0,
        read_len_mean=600, read_len_sd=80, errors=lerr, prefix=lc.name)
        for lc in loci]
    singles.append(sim.simulate_single_reads(
        rng, [genome], depth=3.0, read_len_mean=600, read_len_sd=80,
        errors=lerr, prefix="bg"))
    long_fq = root / "long.fq.gz"
    with smart_create(long_fq) as f:
        for p in singles:
            for name, a in zip(p.names, p.reads1):
                fastx.write_fastq(f, fastx.Read(name, a))
    db = root / "db"
    assert torch_cli("add", "-d", db, "-r", root / "ref.fa", "-l",
                     root / "loci.bed", "-s", root / "haps_{}.fa") == 0
    region = ["-b", "chr1:2000-58000"]
    assert torch_cli("preproc", "-i", r1, r2, "-r", root / "ref.fa",
                     "-o", root / "short", *region) == 0
    assert torch_cli("preproc", "-i", long_fq, "-r", root / "ref.fa",
                     "-o", root / "long", "--tech", "hifi", *region) == 0
    return SimpleNamespace(
        root=root, db=db, n_haps=sum(len(lc.haplotypes) for lc in loci),
        inputs={"short": [r1, r2], "long": [long_fq]})


@pytest.mark.parametrize("reads, built_in", [("short", "align.post"),
                                             ("long", "solve.prep")])
def test_profile_built_once_a_call_and_again_the_next(small_world, reads,
                                                      built_in, monkeypatch):
    """Each call's `compl_haps` is the loci's haplotypes, counted once (two
    one-haplotype passes a haplotype before), in the summary line too; each
    locus's profile is built in the step that first reads it; the second
    call builds them again."""
    where = []
    orig = NeighbProfile._build

    def build(self):
        if not self._built:
            where.append(spans.current().name)
        return orig(self)

    monkeypatch.setattr(NeighbProfile, "_build", build)
    w = small_world
    for i in range(2):
        where.clear()
        assert torch_cli("genotype", "-i", *w.inputs[reads], "-d", w.db,
                         "-p", w.root / reads, "-o", w.root / f"{reads}{i}",
                         *LIGHT) == 0
        root = spans.snapshot()[-1]
        assert root.name == "genotype" and root.end is not None
        assert root.attrs["compl_haps"] == w.n_haps
        assert f"compl_haps={w.n_haps}" in summary(root).split()
        assert where == [built_in, built_in]
        for name in ("GA", "GB"):
            assert (w.root / f"{reads}{i}" / "loci" / name
                    / "res.json.gz").exists()
