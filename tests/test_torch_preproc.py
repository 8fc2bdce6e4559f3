"""`preproc` of the port against the JAX package's, on the same files.

One world, that of tests/test_preproc_stream.py: a 400 kb genome, paired
reads at 24x drawn from all of it, in genome order, and a 60 kb background
region whose padded 160 kb hold about 40 % of the reads.  Both packages'
`preproc` run on it once with their default flags; the port runs with
`--device cpu` (the plain PyTorch versions of the kernels).

What the estimation counts is compared exactly: the insert sizes and the
same/opposite orientation counts (`InsertDistr.estimate`), the error-op counts
and the (edit, length) triples (`ErrorProfile.estimate`), and the depth counts
per kept window with their GC (`ReadDepth.estimate`).  Every float of
`distr.json.gz` is compared within a relative 1e-9: both packages derive them
from those counts with the same numpy code, so only the order of a float sum
could move them.

The two packages align with different kernels on the CPU: the JAX package
with its XLA scan (unbounded deletion runs, ties taken with >=), the port
with the rules of the Pallas kernel (deletion runs capped at min(32, band),
ties taken with >).  The function-level test compares the best alignment of
every mate and names, for any mate where they differ, the rule that moved it.
"""
import gzip
import importlib
import io
import json
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from locityper_tpu import bg as jbg
from locityper_tpu import cli as jcli
from locityper_tpu import pipeline as jpipeline
from locityper_tpu import sim
from locityper_tpu.bg import depth as jdepth
from locityper_tpu.bg import err_prof as jerr
from locityper_tpu.bg import insertsz as jins
from locityper_tpu.seq.counts import GenomeKmerCounter as JCounter
from locityper_tpu.seq import fastx
from locityper_tpu_torch import bg as tbg
from locityper_tpu_torch import cli as tcli
from locityper_tpu_torch import pipeline as tpipeline
from locityper_tpu_torch.bg import depth as tdepth
from locityper_tpu_torch.bg import err_prof as terr
from locityper_tpu_torch.bg import insertsz as tins
from locityper_tpu_torch.bg.depth import ReadDepthParams
from locityper_tpu_torch.commands import preproc as TP
from locityper_tpu_torch.seq.counts import GenomeKmerCounter

torch.set_num_threads(1)        # the suite runs several workers side by side

REGION = "chr1:170000-230000"
PADDED = (120_000, 280_000)     # REGION +- preproc's BG_PADDING
DEPTH = 24.0
FLOAT_REL = 1e-9


def make_world(root):
    """tests/test_preproc_stream.py's world: reads in genome order."""
    rng = np.random.default_rng(11)
    genome = sim.random_genome(rng, 400_000)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    reads = sim.simulate_paired_reads(rng, [genome], depth=DEPTH, errors=err)
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    with open(root / "r1.fq", "w") as f1, open(root / "r2.fq", "w") as f2:
        for nm, s1, s2 in zip(reads.names, reads.reads1, reads.reads2):
            fastx.write_fastq(f1, fastx.Read(nm, s1))
            fastx.write_fastq(f2, fastx.Read(nm, s2))
    return SimpleNamespace(root=root, genome=genome, reads=reads,
                           ref=root / "ref.fa", r1=root / "r1.fq",
                           r2=root / "r2.fq")


def preproc_args(world, out, *extra, inputs=None):
    inputs = inputs or ["-i", world.r1, world.r2]
    return ["preproc", *map(str, inputs), "-r", str(world.ref), "-o",
            str(out), *map(str, extra)]


def run_both(world, name, *extra, inputs=None):
    """Both CLIs on the same files; returns (JAX json, port json)."""
    j_out, t_out = world.root / f"j_{name}", world.root / f"t_{name}"
    assert jcli.main(preproc_args(world, j_out, *extra, inputs=inputs)) == 0
    assert tcli.main(["--device", "cpu", *preproc_args(
        world, t_out, *extra, inputs=inputs)]) == 0
    return read_distr(j_out), read_distr(t_out)


def read_distr(out):
    with gzip.open(out / "bg" / "distr.json.gz", "rt") as f:
        return json.load(f)


def assert_same_json(a, b, where="distr"):
    """Integers, strings and keys exactly, floats within FLOAT_REL."""
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, \
        f"{where}: {a!r} != {b!r}"
    if isinstance(a, dict):
        assert set(a) == set(b), f"{where}: keys {set(a) ^ set(b)}"
        for k in a:
            assert_same_json(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), f"{where}: {len(a)} != {len(b)} entries"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_json(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=FLOAT_REL, abs=1e-300), \
            f"{where}: {a!r} != {b!r}"
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


class Capture:
    """Records the inputs of the three estimators of one package: what the
    estimation counted, before any float is derived from it."""

    def __init__(self, monkeypatch, insertsz, err_prof, depth):
        self.calls = {}
        for name, cls in (("insert", insertsz.InsertDistr),
                          ("errors", err_prof.ErrorProfile),
                          ("depth", depth.ReadDepth)):
            monkeypatch.setattr(cls, "estimate",
                                staticmethod(self._wrap(name, cls.estimate)))

    def _wrap(self, name, estimate):
        def recorded(*args, **kw):
            self.calls[name] = (args, kw)
            return estimate(*args, **kw)
        return recorded

    def counts(self):
        sizes, same_o, opp_o = self.calls["insert"][0]
        n_match, n_mism, n_ins, n_del, triples = self.calls["errors"][0]
        (depth1, gc), kw = self.calls["depth"][0][:2], \
            self.calls["depth"][1]
        return dict(insert_sizes=np.sort(np.asarray(sizes)).tolist(),
                    same_orient=same_o, opp_orient=opp_o,
                    ops=(n_match, n_mism, n_ins, n_del),
                    triples=sorted(triples),
                    depth=np.asarray(depth1).tolist(),
                    gc=np.asarray(gc).tolist(),
                    subsampling_rate=kw["subsampling_rate"])


def assert_same_counts(j_counts, t_counts):
    for key in j_counts:
        assert t_counts[key] == j_counts[key], key


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("torchpre"))


@pytest.fixture(scope="module")
def default_runs(world):
    """Both packages' `preproc` with default flags, once, recording what
    each estimation counted.  The port's run also guards the single pass
    over the input: `_count_input`, the full re-scan of `--like`, fails."""
    with pytest.MonkeyPatch.context() as mp:
        j_cap = Capture(mp, jins, jerr, jdepth)
        t_cap = Capture(mp, tins, terr, tdepth)
        mp.setattr(TP, "_count_input",
                   lambda *a: pytest.fail("preproc re-scanned the input"))
        j_json, t_json = run_both(world, "default", "-b", REGION)
    return SimpleNamespace(j_json=j_json, t_json=t_json,
                           j_counts=j_cap.counts(), t_counts=t_cap.counts())


def test_default_distr_equal(default_runs):
    assert_same_json(default_runs.j_json, default_runs.t_json)


def test_default_counts_exact(default_runs):
    j, t = default_runs.j_counts, default_runs.t_counts
    assert_same_counts(j, t)
    # The world's own numbers: ~12,700 pairs recruited, insert N(400, 60).
    assert len(t["insert_sizes"]) > 10_000
    assert np.mean(t["insert_sizes"]) == pytest.approx(400, rel=0.02)
    assert t["opp_orient"] > 100 * max(t["same_orient"], 1)
    assert t["subsampling_rate"] == 1.0


def test_single_pass_io(world, default_runs):
    """total_reads is the count of the recruitment stream (the fixture's
    run fails if `_count_input` re-scans); the file size is the inputs'."""
    info = default_runs.t_json["seq_info"]
    with open(world.r1) as f:
        n_pairs = sum(1 for _ in f) // 4
    assert info["total_reads"] == n_pairs == len(world.reads.names)
    assert info["file_size"] == (world.r1.stat().st_size
                                 + world.r2.stat().st_size)


def test_default_depth_reads_back(default_runs):
    """The formula of tests/test_preproc_stream.py, on the port's file."""
    bg = tbg.BgDistr.from_json(default_runs.t_json)
    d = bg.depth.depth_distribution(41)
    est = d.mean() * 2 * 2 * 150.0 / bg.depth.window_size
    assert est == pytest.approx(DEPTH, rel=0.25)


def test_like_and_describe(world, default_runs):
    """`--like` rescales the donor's depth by the read-count ratio (a full
    count of the new input) or, with `--file-size`, by the size ratio;
    `--describe` prints the same text in both packages."""
    for extra in ([], ["--file-size"]):
        tag = "like" + "".join(extra).replace("-", "_")
        j_json, t_json = (
            read_distr(out) for out in _like_both(world, tag, extra))
        assert_same_json(j_json, t_json)
    texts = []
    for main, prefix, name in ((jcli.main, [], "j_default"),
                               (tcli.main, ["--device", "cpu"],
                                "t_default")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main([*prefix, "preproc", "-i", "x", "-r", "x", "-o",
                         str(world.root / name), "--describe"]) == 0
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "insert size: 39" in texts[1] and "total reads: 32000" in texts[1]


def _like_both(world, tag, extra):
    outs = []
    for main, prefix, side in ((jcli.main, [], "j"),
                               (tcli.main, ["--device", "cpu"], "t")):
        out = world.root / f"{side}_{tag}"
        assert main([*prefix, *preproc_args(
            world, out, "--like", world.root / f"{side}_default",
            *extra, inputs=["-i", world.r1])]) == 0
        outs.append(out)
    return outs


# --- estimate_bg_from_reads at the function ---------------------------------

def _best_per_mate(pkg, mates, region, device_kw):
    """The estimation's best alignment of every mate (highest ln_prob, as
    `estimate_bg_from_reads` picks it), by the aligner of package `pkg`."""
    locs = importlib.import_module(f"{pkg}.model.locs")
    align = importlib.import_module(f"{pkg}.ops.align")
    contigs = importlib.import_module(f"{pkg}.seq.contigs")
    cset = contigs.ContigSet("bg", ["bg"], [region])
    index = locs.HapMinimizerIndex(cset, 15, 10)
    jobs = index.candidates_batch_flat(mates, 10, 48, 2, 2)
    sv = np.array(align.Scores.from_error_rates(0.005, 0.001, 0.001)
                  .astuple(), np.float32)
    lists = locs._align_candidates(mates, jobs, cset, sv, 48,
                                   **device_kw).to_lists(len(mates))
    return [max(a, key=lambda x: x.ln_prob) if a else None for a in lists]


def _rule(j, t):
    """Which aligner rule separates the two best alignments of one mate."""
    if j is None or t is None:
        return "one aligner found no candidate alignment"
    if j.ln_prob == t.ln_prob:
        return ("tie: the XLA scan takes ties with >=, the port (as the "
                "Pallas kernel) with >")
    if j.ln_prob > t.ln_prob:
        return ("cap: the XLA scan's deletion runs are unbounded, the "
                "port's (as the Pallas kernel's) end at min(32, band)")
    return "neither rule: the port scored higher"


def test_estimate_bg_from_reads_equals_jax(world, monkeypatch):
    """1,500 pairs from the padded region, both packages' estimation on the
    same reads, region and k-mer counts, with `--max-reads`' depth
    correction and the CLI's filters: every count exact, every float within
    FLOAT_REL; and the best alignment of every mate equal."""
    rd = world.reads
    lo, hi = PADDED
    inside = [i for i, p in enumerate(rd.source_pos) if lo <= p < hi - 400]
    pick = np.sort(np.random.default_rng(0).choice(len(inside), 1500,
                                                   replace=False))
    ix = [inside[i] for i in pick]
    reads1 = [rd.reads1[i] for i in ix]
    reads2 = [rd.reads2[i] for i in ix]
    names = [rd.names[i] for i in ix]
    region = world.genome[lo:hi]
    kw = dict(subsampling_rate=0.125, insert_pval=0.001, edit_pval=0.01,
              max_clipping=0.02, min_mapq=30)
    j_cap = Capture(monkeypatch, jins, jerr, jdepth)
    t_cap = Capture(monkeypatch, tins, terr, tdepth)

    mates = [m for pair in zip(reads1, reads2) for m in pair]
    j_best = _best_per_mate("locityper_tpu", mates, region, {})
    t_best = _best_per_mate("locityper_tpu_torch", mates, region,
                            {"device": "cpu"})
    fields = ("start", "end", "fwd", "n_mism", "n_ins", "n_del", "n_clip",
              "edit", "ln_prob")
    moved = []
    for m, (j, t) in enumerate(zip(j_best, t_best)):
        jv = None if j is None else tuple(getattr(j, f) for f in fields)
        tv = None if t is None else tuple(getattr(t, f) for f in fields)
        if jv != tv:
            moved.append(f"{names[m // 2]}/{m % 2 + 1}: JAX {jv}, port {tv}"
                         f" — {_rule(j, t)}")
    assert not moved, f"{len(moved)} mates moved:\n" + "\n".join(moved[:20])
    assert sum(b is not None for b in t_best) > 0.98 * len(mates)

    j_counter, t_counter = JCounter(25), GenomeKmerCounter(25)
    for c in (j_counter, t_counter):
        c.add_seq(world.genome)
        c.finalize()
    j_bgd = jpipeline.estimate_bg_from_reads(
        reads1, reads2, region, j_counter, jbg.Technology.ILLUMINA,
        depth_params=jdepth.ReadDepthParams(), **kw)
    t_bgd = tpipeline.estimate_bg_from_reads(
        reads1, reads2, region, t_counter, tbg.Technology.ILLUMINA,
        depth_params=ReadDepthParams(), device="cpu", **kw)
    assert_same_counts(j_cap.counts(), t_cap.counts())
    assert_same_json(j_bgd.to_json(), t_bgd.to_json())
    assert t_cap.counts()["subsampling_rate"] == 0.125


def test_estimate_bg_from_reads_needs_a_device_or_cpu(world):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    counter = GenomeKmerCounter(25)
    counter.add_seq(world.genome[:20_000])
    counter.finalize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.estimate_bg_from_reads(
            world.reads.reads1[:10], world.reads.reads2[:10],
            world.genome[:20_000], counter, tbg.Technology.ILLUMINA)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(preproc_args(world, world.root / "nodev", "-b", REGION))
