"""The batched-move engine (`e=batched`) of the port against the JAX package.

The port's `ops/solver_batched.py` runs on `device="cpu"`; the JAX
package's `ops/solver_batched.py` on the CPU.  The two draw different random
numbers (counter-based Philox in the port, threefry in JAX), so the walks
are held against the exact ILP optimum (the counterpart of
tests/test_ilp.py:77-100), a float64 host re-scoring and the calls of the
JAX package on a two-locus panel.  `Stage.parse` with `b=` equals the JAX
package's field for field.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from locityper_tpu.bg.err_prof import EditDistCache as JEditDistCache
from locityper_tpu.bg.err_prof import EditThresh as JEditThresh
from locityper_tpu.model import Params as JParams
from locityper_tpu.model.locs import \
    build_all_alignments_panel as j_build_panel
from locityper_tpu.pipeline import genotype_panel as j_genotype_panel
from locityper_tpu.solvers.solve import Scheme as JScheme
from locityper_tpu.solvers.solve import Stage as JStage
from locityper_tpu_torch import convert
from locityper_tpu_torch.bg.err_prof import EditDistCache, EditThresh
from locityper_tpu_torch.model import Params
from locityper_tpu_torch.model.locs import build_all_alignments_panel
from locityper_tpu_torch.ops import solver_batched as TB
from locityper_tpu_torch.pipeline import genotype_panel
from locityper_tpu_torch.solvers import ilp as TILP
from locityper_tpu_torch.solvers.solve import Scheme, Stage

# One intra-op thread: the suite runs several workers side by side, and the
# tensors here are small.
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_locs import TRUTH, build_panel, make_params  # noqa: E402
from test_torch_locs import recruit_both  # noqa: E402
from test_torch_seq import host_liks  # noqa: E402
from test_torch_solver import ALL_GTS, cfg_pair, problem  # noqa: E402
from test_torch_solver import torch_args  # noqa: E402


def batched_cfg(params, pack):
    """tests/test_ilp.py:84's configuration: 500 cooling super-steps of
    1,000, a third of the accepted moves kept."""
    _, cfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=0)
    return dataclasses.replace(cfg, anneal_steps_b=500, move_thin=0.3)


def run_batched(seed, gts, tensors, pack, bayes, cfg, attempts, n_steps=1000,
                random_init=True, first_row=0):
    liks, assgn = TB.solve_genotypes(
        seed, np.asarray(gts), *torch_args(tensors, pack, bayes), cfg,
        n_attempts=attempts, max_windows=pack.max_windows, n_steps=n_steps,
        random_init=random_init, first_row=first_row, device="cpu")
    return liks.numpy(), assgn.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_reaches_ilp_optimum(seed):
    """tests/test_ilp.py:78 with the port's engine: 8 attempts of 1,000
    super-steps; the best within 0.05 of the exact optimum, never above it,
    and every likelihood equal to its host re-scoring."""
    tensors, pack, bayes, params = problem(seed)
    gt = (0, 2)
    _, ilp_lik = TILP.solve_ilp(gt, convert.from_reference(tensors),
                                convert.from_reference(pack), bayes, params)
    liks, assgn = run_batched(seed, [gt], tensors, pack, bayes,
                              batched_cfg(params, pack), 8)
    best = float(liks.max())
    assert best == pytest.approx(ilp_lik, abs=0.05), (best, ilp_lik)
    assert best <= ilp_lik + 0.05
    np.testing.assert_allclose(
        liks[0], host_liks(gt, assgn[0], tensors, pack, bayes, params),
        rtol=0, atol=1e-3)


def test_batched_chunk_equals_genotypes_one_at_a_time():
    """Counter-based draws: a chain's walk depends on its (row, attempt),
    not on the other chains of its call; greedy (no cooling, best start)
    and annealing alike."""
    tensors, pack, bayes, params = problem(2)
    cfg = batched_cfg(params, pack)
    for greedy in (False, True):
        c = dataclasses.replace(cfg, anneal_steps_b=0) if greedy else cfg
        liks, assgn = run_batched(7, ALL_GTS, tensors, pack, bayes, c, 3,
                                  n_steps=200, random_init=not greedy)
        for gi, gt in enumerate(ALL_GTS):
            one_l, one_a = run_batched(7, [gt], tensors, pack, bayes, c, 3,
                                       n_steps=200, random_init=not greedy,
                                       first_row=gi)
            np.testing.assert_array_equal(one_l[0], liks[gi])
            np.testing.assert_array_equal(one_a[0], assgn[gi])
    other, _ = run_batched(8, ALL_GTS, tensors, pack, bayes, cfg, 3,
                           n_steps=200)
    assert not np.array_equal(other, liks)


STAGE_FIELDS = ("kind", "in_size", "attempts", "anneal_steps", "polish_steps",
                "engine", "batched_steps", "batched_anneal", "sample", "plato",
                "seed_prev")


@pytest.mark.parametrize("specs", [
    [],
    ["greedy:i=5k,a=1,e=batched", "anneal:i=20,a=20,e=batched"],
    ["greedy:b=900,e=batched", "anneal:b=2k,i=8"],
    ["greedy:bsteps=250", "anneal:i=20,a=20,b=300,e=batched,init=prev"],
])
def test_stage_parse_b_equals_reference(specs):
    """`b=` sets the super-steps; a greedy stage has no cooling and at most
    400 super-steps (the reference's clamp), also in the default scheme."""
    a, b = Scheme.parse(specs), JScheme.parse(specs)
    assert len(a.stages) == len(b.stages)
    for sa, sb in zip(a.stages, b.stages):
        for f in STAGE_FIELDS:
            assert getattr(sa, f) == getattr(sb, f), (specs, f)
    for spec in specs:
        sa, sb = Stage.parse(spec), JStage.parse(spec)
        assert [getattr(sa, f) for f in STAGE_FIELDS] \
            == [getattr(sb, f) for f in STAGE_FIELDS]


BATCHED = ["greedy:i=5k,a=1,e=batched", "anneal:i=8,a=4,b=300,e=batched"]


def two_locus_panel():
    """Two loci (5 and 6 haplotypes, one homozygous truth): both packages'
    recruited reads and alignments, the port's objects and the JAX
    package's ("j_")."""
    p = build_panel(n_haps=(5, 6))
    j_rec, rec = recruit_both(p)
    order = list(p["j_data"])
    j_bg, bg = p["j_bg"], p["bg"]
    j_params, params = make_params(JParams, j_bg), make_params(Params, bg)
    j_built = j_build_panel(
        [(j_rec[n][0], j_rec[n][1], p["j_data"][n].contig_set,
          p["j_data"][n].kmer_counts) for n in order], j_bg,
        JEditDistCache(j_bg.err_prof,
                       JEditThresh.default_for(j_bg.seq_info.technology)),
        j_params, mesh=None)
    panel = [(rec[n][0], rec[n][1], p["data"][n].contig_set,
              p["data"][n].kmer_counts) for n in order]
    cache = EditDistCache(bg.err_prof,
                          EditThresh.default_for(bg.seq_info.technology))
    built = build_all_alignments_panel(panel, bg, cache, params,
                                       device="cpu")
    j_entries = [dict(locus=p["j_data"][n], read_pairs=j_rec[n][0],
                      names=j_rec[n][1], tag=n, prebuilt=j_built[i])
                 for i, n in enumerate(order)]
    entries = [dict(locus=p["data"][n], read_pairs=rec[n][0],
                    names=rec[n][1], tag=n, prebuilt=built[i])
               for i, n in enumerate(order)]
    return dict(j_entries=j_entries, j_bg=j_bg, j_params=j_params,
                entries=entries, bg=bg, params=params, panel=panel,
                cache=cache, built=built)


def assert_same_calls(out, j_out):
    """Calls equal to the truth and to the JAX package's; the called
    genotype's mean ln-likelihood within 4 standard errors + 1.0 (ROADMAP
    Queue C item 9)."""
    for (res, _), (j_res, _), truth in zip(out, j_out, TRUTH):
        call = tuple(sorted(int(h) for h in res.genotypes[0]))
        assert call == truth, (res.tag, call, truth)
        assert call == tuple(sorted(int(h) for h in j_res.genotypes[0]))
        pa, pb = res.predictions[0], j_res.predictions[0]
        bound = 4.0 * np.sqrt(pa.lik_var / pa.attempts
                              + pb.lik_var / pb.attempts) + 1.0
        assert pa.lik_mean == pytest.approx(pb.lik_mean, abs=bound)


def test_panel_calls_equal_reference_batched_engine():
    w = two_locus_panel()
    j_out = j_genotype_panel(w["j_entries"], w["j_bg"], params=w["j_params"],
                             scheme=JScheme.parse(BATCHED), seed=3,
                             mesh=None)
    out = genotype_panel(w["entries"], w["bg"], params=w["params"],
                         scheme=Scheme.parse(BATCHED), seed=3, device="cpu")
    assert_same_calls(out, j_out)
    for res, _ in out:
        a = res.predictions[0].assignments
        assert a.dtype == np.int32 and a.shape[0] == 4
