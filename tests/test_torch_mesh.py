"""The port's device grid (`parallel/mesh.py`) against one device and the JAX
package's mesh.

Grids of `["cpu"] * n` (n = 2, 4) run their shards one after the other on
the CPU: the split, the padding, each shard's call and the reduction are the
ones a grid of cards runs.  The JAX side runs on the 8-device virtual CPU
mesh of tests/conftest.py.  Alignment, recruitment and every shard of a
solver stage equal their one-device counterparts to the bit; the read-
sharded filter scores equal the JAX package's within a relative 1e-5 (float32
sums in another order) and select the same genotypes.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from locityper_tpu import sim as jsim
from locityper_tpu.ops.recruit import DeviceIndex as JDeviceIndex
from locityper_tpu.parallel import mesh as JM
from locityper_tpu.pipeline import genotype_panel as j_genotype_panel
from locityper_tpu.seq import dna as jdna
from locityper_tpu.seq.contigs import ContigSet as JContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter as JCounter
from locityper_tpu.seq.counts import off_target_counts as j_off_target
from locityper_tpu.seq.recruit import RecruitParams as JRecruitParams
from locityper_tpu.seq.recruit import TargetIndex as JTargetIndex
from locityper_tpu.solvers.solve import Scheme as JScheme
from locityper_tpu.solvers.solve import select_by_scores as j_select
from locityper_tpu_torch import convert
from locityper_tpu_torch.commands import genotype as G
from locityper_tpu_torch.model.assgn import LocusTensors
from locityper_tpu_torch.model.locs import (_prepare_align_jobs,
                                            build_all_alignments_panel,
                                            run_align_batches)
from locityper_tpu_torch.ops import align as TA
from locityper_tpu_torch.ops import recruit as TR
from locityper_tpu_torch.ops import solver as TS
from locityper_tpu_torch.ops import solver_chains as TC
from locityper_tpu_torch.parallel import mesh as M
from locityper_tpu_torch.pipeline import genotype_panel
from locityper_tpu_torch.seq import fastx
from locityper_tpu_torch.seq.recruit import RecruitParams
from locityper_tpu_torch.solvers.solve import Scheme, select_by_scores
from locityper_tpu_torch.utils.rng import derive_seed

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_batched import assert_same_calls  # noqa: E402
from test_torch_batched import two_locus_panel  # noqa: E402
from test_torch_solver import ALL_GTS, cfg_pair, problem  # noqa: E402
from test_torch_solver import torch_args  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cpu_mesh(n):
    return M.make_mesh(devices=["cpu"] * n)


def test_make_mesh_and_auto_mesh():
    m = cpu_mesh(4)
    assert m.shape == {"read": 2, "gt": 2} and m.devices.size == 4
    assert m.distinct == [torch.device("cpu")] and m.device_type == "cpu"
    assert cpu_mesh(2).shape == {"read": 2, "gt": 1}
    assert M.make_mesh(devices=["cpu"] * 3).shape == {"read": 1, "gt": 3}
    assert M.make_mesh(2, devices=["cpu"] * 4, read_axis=1).shape == {
        "read": 1, "gt": 2}
    with pytest.raises(ValueError):
        M.make_mesh(devices=["cpu"] * 3, read_axis=2)
    with pytest.raises(ValueError):
        M.make_mesh(5, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        assert M.auto_mesh() is None            # no card here
        assert M.resolve_mesh("auto", torch.device("cpu")) is None
    assert M.resolve_mesh(m, torch.device("cpu")) is m
    assert M.resolve_mesh(None, torch.device("cpu")) is None


def align_jobs(seed, N, L=64, band=16):
    """A job table of N reads cut from one haplotype (2 % of bases turned
    to T, every 7th read empty), half of the mates stored as the reverse
    complement of their read, each job at its read's own diagonal."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 4, 3000).astype(np.int8)
    start = rng.integers(band, 2800 - L, N)
    reads = hap[start[:, None] + np.arange(L)].copy()
    reads[rng.random((N, L)) < 0.02] = 3
    lens = rng.integers(L // 2, L + 1, N)
    lens[::7] = 0
    strand = rng.integers(0, 2, N)
    mates = [(3 - r[:n][::-1]).astype(np.int8) if s else r[:n]
             for r, n, s in zip(reads, lens, strand)]
    jobs = (np.arange(N), np.zeros(N, np.int64), strand, start)
    table, _ = _prepare_align_jobs(mates, jobs, SimpleNamespace(seqs=[hap]),
                                   band, L=L)
    sv = np.array(TA.Scores.from_error_rates(0.002, 0.0002, 0.0002)
                  .astuple(), np.float32)
    return table, sv, band


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_align_equals_unsharded(n):
    """37 jobs (padding to a multiple of 2 and of 4), also in batches of
    10 through `run_align_batches(..., mesh=)`: every output equal to the
    one-device call's."""
    jobs, sv, band = align_jobs(n, 37)
    want = run_align_batches(jobs, sv, band, device="cpu")
    mesh = cpu_mesh(n)
    for got in (M.sharded_align(mesh, jobs, sv, band),
                run_align_batches(jobs, sv, band, batch=10, mesh=mesh)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["valid"].any() and not want["valid"].all()


@pytest.fixture(scope="module")
def recruit_case():
    """tests/test_recruit.py:339's case through the JAX package: the index,
    the batches and the decisions of its 8-device sharded recruitment."""
    rng = np.random.default_rng(0)
    locus = jsim.simulate_locus(rng, length=2000, n_haps=3)
    counter = JCounter(25)
    counter.add_seq(np.concatenate([jsim.random_genome(rng, 5000),
                                    locus.haplotypes[0]]))
    counter.finalize()
    idx = JTargetIndex(JRecruitParams(match_frac=0.5))
    idx.add_locus(JContigSet(locus.name, locus.hap_names, locus.haplotypes),
                  j_off_target(counter, locus.haplotypes,
                               locus.haplotypes[0]))
    idx.finalize()
    jdev = JDeviceIndex.from_index(idx)
    B, L = 64, 128
    r1 = np.full((B, L), 4, np.int8)
    r2 = np.full((B, L), 4, np.int8)
    for i in range(B):
        s = int(rng.integers(0, 1800))
        r1[i, :120] = locus.haplotypes[i % 3][s:s + 120]
        r2[i, :120] = jdna.revcomp(locus.haplotypes[0][s:s + 120])
        if i % 5 == 0:                         # non-recruiting noise
            r1[i, :120] = rng.integers(0, 4, 120)
            r2[i, :120] = rng.integers(0, 4, 120)
    want = np.asarray(JM.sharded_recruit_pairs(
        JM.make_mesh(), jdev.cfg, r1, r2, *jdev.tables()))
    return convert.device_index_from_reference(jdev), r1, r2, want


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_recruit_pairs_equals_reference(recruit_case, n):
    """Packed decisions equal the JAX package's sharded ones and the port's
    one-device ones, for the whole batch and for a batch that needs
    padding (61 pairs); the persistent `MeshPairRecruiter` too."""
    dev, r1, r2, want = recruit_case
    mesh = cpu_mesh(n)
    got = M.sharded_recruit_pairs(mesh, dev.cfg, r1, r2, dev.keys_signed,
                                  dev.packed)
    np.testing.assert_array_equal(got, want)
    single = TR.run_pairs_async(dev, r1, r2, device="cpu").numpy()
    np.testing.assert_array_equal(got, single)
    rec = M.MeshPairRecruiter(mesh, dev)
    np.testing.assert_array_equal(rec.run_async(r1[:61], r2[:61]).numpy(),
                                  want[:61])
    hits = TR.unpack_decisions(got, dev.n_loci)
    assert hits.any() and not hits.all()


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_filter_scores_equal_reference(n):
    rng = np.random.default_rng(n)
    H, R = 7, 90
    best_aln = rng.normal(-5.0, 3.0, (H, R)).astype(np.float32)
    gts = np.array([(a, b) for a in range(H) for b in range(a, H)], np.int32)
    priors = rng.normal(0.0, 1.0, gts.shape[0]).astype(np.float32)
    want = np.asarray(JM.sharded_filter_scores(JM.make_mesh(), best_aln, gts,
                                               priors))
    got = M.sharded_filter_scores(cpu_mesh(n), best_aln, gts, priors)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    host = priors.astype(np.float64) + np.maximum(
        best_aln[gts[:, 0]], best_aln[gts[:, 1]]).sum(axis=1)
    np.testing.assert_allclose(got, host, rtol=1e-5)
    for out_size in (3, 10):
        np.testing.assert_array_equal(
            select_by_scores(got.astype(np.float64), 4.0, out_size),
            j_select(want.astype(np.float64), 4.0, out_size))
    with pytest.raises(ValueError):
        M.sharded_filter_scores(cpu_mesh(n), best_aln[:, :R - 1], gts, priors)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("engine", ["chains", "seq"])
def test_stage_solver_shards_equal_single_device_calls(n, engine):
    """Each shard's likelihoods and assignments equal the one-device call on
    that shard's rows with the shard's seed; 6 genotypes pad to 8 over 4
    shards."""
    tensors, pack, bayes, params = problem(1)
    _, cfg = cfg_pair(params, pack, anneal_steps=200, polish_steps=100)
    args = torch_args(tensors, pack, bayes)

    def run(seed, gts, dev):
        mod = TC if engine == "chains" else TS
        return mod.solve_genotypes(seed, gts, *args, cfg, n_attempts=2,
                                   max_windows=pack.max_windows, device=dev)

    mesh = cpu_mesh(n)
    liks, assgns = M.sharded_stage_solver(mesh, run, 11, ALL_GTS)
    assert liks.shape == (6, 2) and assgns.shape[:2] == (6, 2)
    per = -(-6 // n)
    padded = np.concatenate([ALL_GTS, np.repeat(ALL_GTS[-1:], n * per - 6,
                                                0)])
    for ix in range(n):
        lo = ix * per
        one_l, one_a = run(derive_seed(11, "shard", ix),
                           padded[lo:lo + per], torch.device("cpu"))
        hi = min(lo + per, 6)
        assert torch.equal(liks[lo:hi], one_l[:hi - lo])
        assert torch.equal(assgns[lo:hi], one_a[:hi - lo])


def test_full_step_equals_reference():
    """`__graft_entry__.dryrun_multichip`'s step: the read-sharded filter
    scores equal the JAX package's `full_step` within a relative 1e-5; the
    genotype-sharded seq chains equal the one-device call to the bit (the
    engine counts its draws by genotype row)."""
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _synthetic_problem
    from locityper_tpu.model.assgn import LocusTensors as JLocusTensors
    from locityper_tpu.model.windows import ContigInfoPack as JPack
    import jax

    prob = _synthetic_problem(n_reads=32)
    H, R, kh = prob["hap_prob"].shape
    j_tensors = JLocusTensors(prob["hap_prob"], prob["hap_mid"],
                              prob["unmapped_prob"], H, R, kh)
    j_pack = JPack(n_haps=H, max_len=prob["gc_at"].shape[1],
                   max_windows=prob["max_windows"],
                   n_windows=prob["pack_nwin"],
                   reg_start=prob["pack_regstart"],
                   contig_len=prob["pack_len"],
                   window_size=prob["cfg"].window_size,
                   gc_at=prob["gc_at"], weight_at=prob["weight_at"])
    gts = prob["genotypes"]
    priors = np.zeros(gts.shape[0])
    j_scores, j_liks = JM.full_step(JM.make_mesh(), jax.random.PRNGKey(0),
                                    j_tensors, j_pack, prob["bayes"], gts,
                                    priors, prob["cfg"], n_attempts=2)
    jc = prob["cfg"]
    cfg = TS.SolverConfig(anneal_steps=jc.anneal_steps,
                          polish_steps=jc.polish_steps, tweak=jc.tweak,
                          window_size=jc.window_size)
    tensors, pack = convert.from_reference(j_tensors), \
        convert.from_reference(j_pack)
    scores, liks = M.full_step(cpu_mesh(4), 0, tensors, pack, prob["bayes"],
                               gts, priors, cfg, n_attempts=2)
    np.testing.assert_allclose(scores, np.asarray(j_scores), rtol=1e-5)
    assert liks.shape == np.asarray(j_liks).shape == (gts.shape[0], 2)
    assert np.isfinite(liks).all()
    one, _ = TS.solve_genotypes(
        0, gts, tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
        pack.n_windows, pack.reg_start, pack.contig_len, pack.gc_at,
        pack.weight_at, prob["bayes"], cfg, n_attempts=2,
        max_windows=pack.max_windows, device="cpu")
    np.testing.assert_array_equal(liks, one.numpy())


LIGHT = ["greedy:i=5k,a=1", "anneal:i=8,a=4,n=1500,p=1000"]


def test_genotype_panel_same_calls_with_and_without_mesh():
    """The two-locus world: alignments through a grid of 4 equal the one
    device's to the bit; `genotype_panel` with the grid (read-sharded
    filter, genotype-sharded stages) gives the one device's calls and the
    JAX package's."""
    w = two_locus_panel()
    mesh = cpu_mesh(4)
    built = build_all_alignments_panel(w["panel"], w["bg"], w["cache"],
                                       w["params"], mesh=mesh)
    for (a, sa), (b, sb) in zip(built, w["built"]):
        assert sa == sb and a.n_used == b.n_used > 0
        ta, tb = LocusTensors.build(a), LocusTensors.build(b)
        for f in ("hap_prob", "hap_mid", "unmapped_prob"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
    j_out = j_genotype_panel(w["j_entries"], w["j_bg"], params=w["j_params"],
                             scheme=JScheme.parse(LIGHT), seed=3, mesh=None)
    outs = [genotype_panel(w["entries"], w["bg"], params=w["params"],
                           scheme=Scheme.parse(LIGHT), seed=3, mesh=m,
                           device="cpu") for m in (None, mesh)]
    for out in outs:
        assert_same_calls(out, j_out)
    for (a, _), (b, _) in zip(*outs):
        assert a.genotypes[0] == b.genotypes[0]


def test_fast_path_mesh_equals_single_device(tmp_path, monkeypatch):
    """`recruit_reads_fast` shards its batches over `auto_mesh()` (looked
    up at call time, as tests/test_readwidth.py:134 patches it); the reads
    it recruits equal the one-device path's, name by name, in order."""
    from locityper_tpu_torch import sim
    from locityper_tpu_torch.pipeline import LocusData
    from locityper_tpu_torch.seq.contigs import ContigSet
    from locityper_tpu_torch.seq.counts import (GenomeKmerCounter,
                                                off_target_counts)
    rng = np.random.default_rng(5)
    loci = [sim.simulate_locus(rng, f"F{i}", length=2500, n_haps=4)
            for i in range(2)]
    genome = np.concatenate([sim.random_genome(rng, 8000), loci[0]
                             .haplotypes[0], sim.random_genome(rng, 8000),
                             loci[1].haplotypes[0]])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    data = {lc.name: LocusData(
        ContigSet(lc.name, lc.hap_names, lc.haplotypes),
        off_target_counts(counter, lc.haplotypes, lc.haplotypes[0]))
        for lc in loci}
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    rd = sim.simulate_paired_reads(rng, [genome], depth=6.0, errors=err,
                                   prefix="r")
    fq1, fq2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for nm, a, b in zip(rd.names, rd.reads1, rd.reads2):
            fastx.write_fastq(f1, fastx.Read(nm, a))
            fastx.write_fastq(f2, fastx.Read(nm, b))
    rp = RecruitParams(match_frac=0.6)
    single, _ = G.recruit_reads_fast(data, fq1, fq2, rp, batch=300,
                                     device="cpu")
    calls = []

    def grid():
        calls.append(1)
        return cpu_mesh(4)

    monkeypatch.setattr(M, "auto_mesh", grid)
    meshed, _ = G.recruit_reads_fast(data, fq1, fq2, rp, batch=300,
                                     device="cpu")
    assert calls
    for name in data:
        assert meshed[name][1] == single[name][1]
        assert len(single[name][1]) > 0
        for (a1, a2), (b1, b2) in zip(meshed[name][0], single[name][0]):
            np.testing.assert_array_equal(a1, b1)
            np.testing.assert_array_equal(a2, b2)
