"""The sequential solver engine (`e=seq`) of the port against the JAX package.

The port's `ops/solver.py` engine (`_chain`, `_greedy_chain`,
`solve_genotypes`) runs on `device="cpu"`; the JAX package's on the CPU
(`JAX_PLATFORMS=cpu`), where its `auto` engine is this one.  The depth terms
and, with `tweak=0`, the prologue are compared value for value.  The two
engines draw different random numbers (counter-based Philox in the port,
threefry in JAX), so the walks are held against the exact ILP optimum, a
float64 host re-scoring and the calls of the JAX package on a small panel.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locityper_tpu.bg.err_prof import EditDistCache as JEditDistCache
from locityper_tpu.bg.err_prof import EditThresh as JEditThresh
from locityper_tpu.model import Params as JParams
from locityper_tpu.model.locs import \
    build_all_alignments_panel as j_build_panel
from locityper_tpu.ops import solver as JS
from locityper_tpu.pipeline import genotype_panel as j_genotype_panel
from locityper_tpu.solvers.solve import Scheme as JScheme
from locityper_tpu_torch import convert
from locityper_tpu_torch.bg.err_prof import EditDistCache, EditThresh
from locityper_tpu_torch.model import Params
from locityper_tpu_torch.model.locs import build_all_alignments_panel
from locityper_tpu_torch.ops import solver as TS
from locityper_tpu_torch.pipeline import _prepare_solve_inputs, genotype_panel
from locityper_tpu_torch.solvers import ilp as TILP
from locityper_tpu_torch.solvers.solve import PanelItem, Scheme, solve_panel

# One intra-op thread: the suite runs several workers side by side, and the
# tensors here are small.
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_locs import TRUTH, build_panel, make_params  # noqa: E402
from test_torch_locs import recruit_both  # noqa: E402
from test_torch_solver import (ALL_GTS, cfg_pair, problem,  # noqa: E402
                               solver_args, torch_args)


def random_windows(seed, C=5, W=6, n=400):
    """Window characteristics of C chains with W windows, depths up to 300
    (past DEPTH_CAP = 256) and quadruples of windows drawn from W, so that
    every pair of the four coincides often."""
    rng = np.random.default_rng(seed)
    bayes = rng.normal(-3.0, 2.0, (101, TS.DEPTH_CAP)).astype(np.float32)
    win_gc = rng.integers(0, 101, (C, W)).astype(np.int32)
    win_weight = rng.uniform(0.0, 1.0, (C, W)).astype(np.float32)
    win_weight[:, :2] = 0.0
    depth = rng.integers(0, 301, (C, W)).astype(np.int32)
    depth[rng.random((C, W)) < 0.2] = 0
    ws = rng.integers(0, W, (4, C, n)).astype(np.int32)
    return bayes, win_gc, win_weight, depth, ws


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_terms_equal_reference_bit_for_bit(seed):
    bayes, win_gc, win_weight, depth, ws = random_windows(seed)
    C, n = ws.shape[1:]
    t = [torch.from_numpy(x) for x in (bayes, win_gc, win_weight, depth)]
    tws = [torch.from_numpy(w).long() for w in ws]
    jb = jnp.asarray(bayes)

    got = TS._depth_lik_terms(t[0], t[1], t[2], t[3]).numpy()
    want = np.asarray(JS._depth_lik_terms(jb, win_gc, win_weight, depth))
    np.testing.assert_array_equal(got, want)

    d = torch.from_numpy(np.random.default_rng(seed).integers(
        -2, 302, (C, n)))
    got = TS._ln_depth(t[0], t[1], t[2], tws[0], d).numpy()
    want = np.asarray(jax.vmap(
        jax.vmap(JS._ln_depth, in_axes=(None, None, None, 0, 0)),
        in_axes=(None, 0, 0, 0, 0))(jb, win_gc, win_weight, ws[0],
                                    d.numpy().astype(np.int32)))
    np.testing.assert_array_equal(got, want)

    got = TS._depth_lik_diff(t[0], t[1], t[2], t[3], *tws).numpy()
    want = np.asarray(jax.vmap(
        jax.vmap(JS._depth_lik_diff,
                 in_axes=(None, None, None, None, 0, 0, 0, 0)),
        in_axes=(None, 0, 0, 0, 0, 0, 0, 0))(jb, win_gc, win_weight,
                                              depth, *ws))
    np.testing.assert_array_equal(got, want)
    coincide = (ws[:, None] == ws[None, :]).sum(axis=(0, 1)) > 4
    assert coincide.mean() > 0.5        # shared windows are exercised
    assert (depth >= TS.DEPTH_CAP).any()


@pytest.mark.parametrize("seed,per_hap_unmapped", [(0, False), (1, True)])
def test_prologue_equals_reference_with_tweak_0(seed, per_hap_unmapped):
    """Windows, window GC and weight, valid order and count, and the order
    of non-trivial reads: equal to the reference's `_eval_genotype`
    prologue for every genotype and attempt."""
    tensors, pack, bayes, params = problem(seed)
    unm = tensors.unmapped_prob
    if per_hap_unmapped:
        unm = np.stack([unm - 3.0 * h for h in range(3)])
    jcfg, tcfg = cfg_pair(params, pack)
    A = 2
    args = torch_args(tensors, pack, bayes)
    args[2] = torch.as_tensor(unm)
    gts = torch.as_tensor(ALL_GTS).long()
    draws = TS._Draws(seed, torch.arange(len(ALL_GTS)), A)
    prob = TS._seq_problem(draws, gts, A, *args, tcfg, pack.max_windows)
    key = jax.random.PRNGKey(seed)
    for gi, gt in enumerate(ALL_GTS):
        jp, jm, jsl, jv = JS._gather_candidates(
            tensors.hap_prob, tensors.hap_mid, unm, gt, params.prob_diff)
        jo, jc = JS._compact_valid(jv)
        nontrivial = jc > 1
        j_nt = jnp.argsort(~nontrivial, stable=True)
        np.testing.assert_array_equal(prob.probs[gi].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(prob.vorder[gi].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(prob.vcount[gi].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(prob.nt_ixs[gi].numpy(),
                                      np.asarray(j_nt))
        assert int(prob.ntc[gi]) == int(nontrivial.sum())
        for a in range(A):
            c = gi * A + a
            gc, wt = JS._window_tables(
                key, gt, pack.n_windows, pack.reg_start, pack.contig_len,
                pack.gc_at, pack.weight_at, pack.window_size, 0,
                pack.max_windows)
            wins = JS._read_windows(key, gt, jm, jsl, pack.n_windows,
                                    pack.reg_start, pack.window_size, 0,
                                    pack.max_windows)
            np.testing.assert_array_equal(prob.win_gc[c].numpy(),
                                          np.asarray(gc))
            np.testing.assert_array_equal(prob.win_weight[c].numpy(),
                                          np.asarray(wt))
            np.testing.assert_array_equal(prob.wins[c].numpy(),
                                          np.asarray(wins))


def run_seq(seed, gts, tensors, pack, bayes, cfg, n_attempts,
            random_init=True, first_row=0):
    liks, assgn = TS.solve_genotypes(
        seed, np.asarray(gts), *solver_args(tensors, pack, bayes), cfg,
        n_attempts=n_attempts, max_windows=pack.max_windows,
        random_init=random_init, first_row=first_row, device="cpu")
    return liks.numpy(), assgn.numpy()


def host_liks(gt, assgn, tensors, pack, bayes, params):
    """float64 re-scoring of each attempt's assignment (DEPTH_CAP = 256)."""
    t_tensors, t_pack = (convert.from_reference(tensors),
                         convert.from_reference(pack))
    probs, wins, valid, win_gc, win_weight = TILP.assemble_genotype_host(
        gt, t_tensors, t_pack, bayes, params.prob_diff)
    out = []
    for row in assgn:
        assert valid[np.arange(row.size), row].all()
        out.append(TILP.likelihood_of_assignment(
            row, probs, wins, win_gc, win_weight, bayes,
            params.depth_contrib, params.aln_contrib))
    return np.array(out)


# The best of 64 attempts.  tests/test_ilp.py takes the best of 8 (anneal)
# and of 4 (greedy) attempts, which is the optimum for its threefry streams
# but not for every stream: of the 4 greedy attempts from the best start,
# each ends in the local optimum its order of moves leads to (the JAX
# engine's own 4 end 0.045 below the optimum on problem 0).  64 attempts
# reach it on every problem here, and the tolerance is 1e-3 where
# tests/test_ilp.py allows 0.05.
ATTEMPTS = 64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_reaches_ilp_optimum(seed):
    """tests/test_ilp.py:57 with the seq `_chain`: 4,000 anneal + 4,000
    polish steps from random starts; every likelihood equals its host
    re-scoring."""
    tensors, pack, bayes, params = problem(seed)
    gt = (0, 2)
    _, ilp_lik = TILP.solve_ilp(gt, convert.from_reference(tensors),
                                convert.from_reference(pack), bayes, params)
    _, cfg = cfg_pair(params, pack, anneal_steps=4000, polish_steps=4000)
    liks, assgn = run_seq(seed, [gt], tensors, pack, bayes, cfg, ATTEMPTS)
    best = float(liks.max())
    assert best == pytest.approx(ilp_lik, abs=1e-3), (best, ilp_lik)
    assert best <= ilp_lik + 1e-3
    np.testing.assert_allclose(
        liks[0], host_liks(gt, assgn[0], tensors, pack, bayes, params),
        rtol=0, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_chain_reaches_ilp_optimum(seed):
    """tests/test_ilp.py:108 with the seq `_greedy_chain`: sample 10,
    plateau 100, from the best start."""
    tensors, pack, bayes, params = problem(seed)
    gt = (0, 2)
    _, ilp_lik = TILP.solve_ilp(gt, convert.from_reference(tensors),
                                convert.from_reference(pack), bayes, params)
    _, cfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=0,
                      greedy_sample=10, plato_size=100)
    liks, assgn = run_seq(seed, [gt], tensors, pack, bayes, cfg, ATTEMPTS,
                          random_init=False)
    best = float(liks.max())
    assert best == pytest.approx(ilp_lik, abs=1e-3), (best, ilp_lik)
    assert best <= ilp_lik + 1e-3
    np.testing.assert_allclose(
        liks[0], host_liks(gt, assgn[0], tensors, pack, bayes, params),
        rtol=0, atol=1e-3)


def greedy_run(tensors, pack, bayes, cfg, gts, attempts, stop_check,
               random_init=False, seed=0):
    """`_greedy_chain` directly: (lik, assgn, iterations) of every chain."""
    args = torch_args(tensors, pack, bayes)
    gts = torch.as_tensor(np.asarray(gts)).long()
    draws = TS._Draws(seed, torch.arange(gts.shape[0]), attempts)
    prob = TS._seq_problem(draws, gts, attempts, *args, cfg,
                           pack.max_windows)
    return TS._greedy_chain(draws, prob, cfg, random_init,
                            stop_check=stop_check)


def test_greedy_plateau_terminates():
    """tests/test_ilp.py:132: the chains stop through the plateau rule
    (plato_size + 1 iterations without a gain), long before the iteration
    cap."""
    tensors, pack, bayes, params = problem(3)
    _, cfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=0,
                      greedy_sample=10, plato_size=50)
    lik, _, iters = greedy_run(tensors, pack, bayes, cfg, [(0, 1)], 2, 64)
    assert torch.isfinite(lik).all()
    assert (iters >= 51).all() and (iters < 100_000).all(), iters


def test_greedy_stop_check_does_not_change_the_result():
    """Looking at "all stopped" every 64 iterations gives what looking at
    it every iteration gives: a stopped chain does not move."""
    tensors, pack, bayes, params = problem(1)
    _, cfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=0,
                      greedy_sample=10, plato_size=20)
    a = greedy_run(tensors, pack, bayes, cfg, ALL_GTS, 3, 64,
                   random_init=True, seed=4)
    b = greedy_run(tensors, pack, bayes, cfg, ALL_GTS, 3, 1,
                   random_init=True, seed=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a[2].min()) < int(a[2].max())   # chains stop at different times


@pytest.mark.parametrize("greedy", [False, True])
def test_chunk_equals_genotypes_one_at_a_time(greedy):
    """Counter-based draws: a chain's walk depends on its (row, attempt),
    not on the other chains of its call."""
    tensors, pack, bayes, params = problem(2)
    if greedy:
        _, cfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=0,
                          greedy_sample=5, plato_size=30)
    else:
        _, cfg = cfg_pair(params, pack, anneal_steps=300, polish_steps=200)
    liks, assgn = run_seq(7, ALL_GTS, tensors, pack, bayes, cfg, 3)
    for gi, gt in enumerate(ALL_GTS):
        one_l, one_a = run_seq(7, [gt], tensors, pack, bayes, cfg, 3,
                               first_row=gi)
        np.testing.assert_array_equal(one_l[0], liks[gi])
        np.testing.assert_array_equal(one_a[0], assgn[gi])
    other, _ = run_seq(8, ALL_GTS, tensors, pack, bayes, cfg, 3)
    assert not np.array_equal(other, liks)


SEQ = ["greedy:i=5k,a=1,e=seq", "anneal:i=8,a=6,n=2000,p=1000,e=seq"]


@pytest.fixture(scope="module")
def panel_solved():
    """Two loci (5 and 6 haplotypes, one homozygous truth) through both
    packages: the port under e=seq, the JAX package under `auto` (its seq
    engine on the CPU)."""
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
    built = build_all_alignments_panel(
        [(rec[n][0], rec[n][1], p["data"][n].contig_set,
          p["data"][n].kmer_counts) for n in order], bg,
        EditDistCache(bg.err_prof,
                      EditThresh.default_for(bg.seq_info.technology)),
        params, device="cpu")
    j_out = j_genotype_panel(
        [dict(locus=p["j_data"][n], read_pairs=j_rec[n][0],
              names=j_rec[n][1], tag=n, prebuilt=j_built[i])
         for i, n in enumerate(order)], j_bg, params=j_params,
        scheme=JScheme.parse([s.replace(",e=seq", "") for s in SEQ]),
        seed=3, mesh=None)
    entries = [dict(locus=p["data"][n], read_pairs=rec[n][0],
                    names=rec[n][1], tag=n, prebuilt=built[i])
               for i, n in enumerate(order)]
    out = genotype_panel(entries, bg, params=params, scheme=Scheme.parse(SEQ),
                         seed=3, device="cpu")
    return dict(entries=entries, bg=bg, params=params, j_out=j_out, out=out)


def test_panel_calls_equal_reference_seq_engine(panel_solved):
    """Same calls as the JAX package; the called genotype's mean
    ln-likelihood within 4 standard errors + 1.0 (ROADMAP Queue C item 9);
    assignments in candidate-slot order, valid for every read."""
    for (res, _), (j_res, _), truth in zip(panel_solved["out"],
                                           panel_solved["j_out"], TRUTH):
        call = tuple(sorted(int(h) for h in res.genotypes[0]))
        assert call == truth, (res.tag, call, truth)
        assert call == tuple(sorted(int(h) for h in j_res.genotypes[0]))
        pa, pb = res.predictions[0], j_res.predictions[0]
        bound = 4.0 * np.sqrt(pa.lik_var / pa.attempts
                              + pb.lik_var / pb.attempts) + 1.0
        assert pa.lik_mean == pytest.approx(pb.lik_mean, abs=bound)
        assert pa.assignments.shape == pb.assignments.shape
        assert pa.assignments.dtype == np.int32


def test_engine_names(panel_solved):
    """e=pallas is the chains annealer (the reference's name for the kernel
    that it replaces), e=seq the sequential engine, e=batched the
    batched-move engine."""
    bg, params = panel_solved["bg"], panel_solved["params"]
    items = []
    for e in panel_solved["entries"]:
        prep = _prepare_solve_inputs(e["locus"], e["prebuilt"][0], bg, params,
                                     2, None, None, 0, None)
        items.append(PanelItem(tensors=prep["tensors"], pack=prep["pack"],
                               genotypes=prep["genotypes"],
                               priors=prep["priors"], tag=e["tag"]))
    spec = "anneal:i=6,a=3,n=300,p=200"

    def solve(engine):
        return solve_panel(items, bg, params,
                           Scheme.parse([f"{spec},e={engine}"]), 5,
                           device="cpu")

    pallas, chains, seq = solve("pallas"), solve("chains"), solve("seq")
    batched = solve("batched")
    for a, b, c, d, truth in zip(pallas, chains, seq, batched, TRUTH):
        assert a.genotypes == b.genotypes
        np.testing.assert_array_equal(a.ln_probs, b.ln_probs)
        assert tuple(sorted(c.genotypes[0])) == truth
        assert tuple(sorted(d.genotypes[0])) == truth
