"""Multi-stage genotype solving and ranking.

Counterpart of reference solvers/solve.rs: a pre-filter on pure alignment
likelihood (:87-122), a pipeline of solver stages over shrinking genotype
sets (:150-251), genotype culling by one-sided Welch t-tests (:318-470), and
final ranking with pairwise probabilities, Phred quality and weighted
genotype distances (:472-767).

Work placement differs from the reference by design: each stage launches
one solver call per genotype chunk, evaluating (genotypes × attempts)
chains in parallel — the parallel-chains annealer (ops/solver_chains.py) or
the sequential engine (ops/solver.py, `e=seq`), both vectorised over the
chains of a call — instead of sharding genotypes over CPU threads.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import _kernels, mathx
from ..model import Params
from ..model.assgn import LocusTensors
from ..model.windows import ContigInfoPack
from ..ops import solver as seq_solver
from ..ops import solver_chains
from ..ops.solver import NEG, SolverConfig, build_bayes_table
from ..utils.logging import get_logger
from ..utils.rng import derive_seed

logger = get_logger("solve")

_SIZE_SUFFIX = {"k": 1000, "m": 1000000}

#: Genotypes per annealer call: bounds the per-call device tensors
#: ([chunk·attempts, R, K] feeds) while keeping thousands of chains in flight.
GT_BATCH = 512


def _parse_size(s: str) -> int:
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([kKmM]?)", s)
    if not m:
        raise ValueError(f"Cannot parse size {s!r}")
    v = float(m.group(1)) * _SIZE_SUFFIX.get(m.group(2).lower(), 1)
    return int(v)


@dataclass
class Stage:
    """One solver stage (solve.rs:138-203): SOLVER[:param=value,...].

    Engines (`e=`): "auto" (default; also spelled "chains", or "pallas",
    the reference package's name for the kernel it replaces) is the
    parallel-chains annealer of ops/solver_chains.py — the hand-written
    CUDA kernel on a CUDA device, its plain PyTorch version on the CPU —
    on either device (the reference sends "auto" to "seq" on the CPU).
    "seq" is the sequential engine of ops/solver.py with the reference's
    semantics: one Metropolis chain for anneal stages, the reference greedy
    (`s=` reads sampled per iteration, stop after a plateau of `p=`
    iterations) for greedy stages; plain PyTorch on either device.  The
    reference package's "batched" engine is not part of this package and
    raises.
    """
    kind: str                    # "greedy" | "anneal"
    in_size: int = 1000
    attempts: int = 20
    anneal_steps: int = 20000
    polish_steps: int = 10000
    engine: str = "auto"
    # Reference-greedy knobs (stoch.rs:36-145): the seq engine implements
    # them exactly; the chains annealer runs a polish walk whose plateau is
    # derived from them (_stage_plato).
    sample: int = 10
    plato: int = 100
    # init=prev: seed every chain from the previous stage's best
    # assignment instead of random init (chains engine; an optimization
    # beyond the reference — off by default).
    seed_prev: bool = False

    @classmethod
    def parse(cls, s: str) -> "Stage":
        name, _, rest = s.partition(":")
        name = name.strip().lower()
        if name in ("anneal", "simanneal", "annealing", "simannealing"):
            st = cls(kind="anneal")
        elif name == "greedy":
            st = cls(kind="greedy", anneal_steps=0, polish_steps=8000, attempts=1)
        else:
            raise ValueError(f"Unknown solver {name!r}")
        if rest:
            for kv in rest.split(","):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k in ("i", "input", "in-size"):
                    st.in_size = _parse_size(v)
                elif k in ("a", "attempts"):
                    st.attempts = int(v)
                elif k in ("n", "steps"):
                    st.anneal_steps = _parse_size(v)
                elif k in ("p", "plato"):
                    st.polish_steps = _parse_size(v)
                    st.plato = _parse_size(v)
                elif k in ("s", "sample"):
                    st.sample = _parse_size(v)
                elif k in ("e", "engine"):
                    st.engine = v.strip()
                elif k == "init":
                    st.seed_prev = v.strip() in ("prev", "stage1", "1")
                else:
                    logger.warning("Unknown stage parameter %r", k)
        return st


@dataclass
class Scheme:
    stages: list

    @classmethod
    def default(cls) -> "Scheme":
        """greedy:i=5k,a=1 → anneal:i=20,a=20 (solve.rs:211-229)."""
        return cls([Stage(kind="greedy", in_size=5000, attempts=1,
                          anneal_steps=0, polish_steps=8000),
                    Stage(kind="anneal", in_size=20, attempts=20)])

    @classmethod
    def parse(cls, specs: list[str]) -> "Scheme":
        if not specs:
            return cls.default()
        return cls([Stage.parse(s) for s in specs])


@dataclass
class Prediction:
    lik_mean: float
    lik_var: float
    attempts: int
    assignments: np.ndarray | None = None


def compare_two_likelihoods(p1: Prediction, p2: Prediction) -> float:
    """ln P(gt1 is better), max of simple normalization and t-test p-value
    (solve.rs:318-335)."""
    simple_norm = p1.lik_mean - mathx.ln_add(p1.lik_mean, p2.lik_mean)
    if (np.isfinite(p1.lik_var) and np.isfinite(p2.lik_var)
            and p1.lik_var > 0 and p2.lik_var > 0):
        if p1.attempts == p2.attempts:
            pval = mathx.unpaired_onesided_t_test(
                p1.lik_mean, p1.lik_var, p2.lik_mean, p2.lik_var,
                float(p1.attempts))
        else:
            pval = mathx.unpaired_onesided_t_test_diffsizes(
                p1.lik_mean, p1.lik_var, p2.lik_mean, p2.lik_var,
                float(p1.attempts), float(p2.attempts))
        return max(simple_norm, np.log(max(pval, 1e-300)))
    return simple_norm


def genotype_distance(gt1, gt2, dist_matrix: np.ndarray) -> float:
    """Min-permutation distance between genotypes (solve.rs:338-347)."""
    import itertools
    best = np.inf
    for perm in itertools.permutations(gt1):
        d = sum(0 if i == j else dist_matrix[i, j] for i, j in zip(perm, gt2))
        best = min(best, d)
    return float(best)


@dataclass
class Genotyping:
    """Final result (solve.rs:556-767)."""
    tag: str
    genotypes: list                 # [(h_0..h_{P-1})] best..worst
    ln_probs: np.ndarray
    predictions: list
    quality: float
    total_reads: int
    weighted_dist: float | None = None
    distances: list | None = None
    unexpl_reads: int | None = None
    warnings: list = field(default_factory=list)

    def to_json(self, hap_names: list[str]):
        def gt_name(gt):
            return ",".join(hap_names[h] for h in gt)
        obj = dict(total_reads=self.total_reads, quality=self.quality)
        if self.weighted_dist is not None:
            obj["weight_dist"] = self.weighted_dist
        if self.unexpl_reads is not None:
            obj["unexpl_reads"] = self.unexpl_reads
        if self.genotypes:
            obj["genotype"] = gt_name(self.genotypes[0])
            options = []
            for i, gt in enumerate(self.genotypes):
                pred = self.predictions[i]
                o = dict(genotype=gt_name(gt),
                         lik_mean=mathx.to_log10(pred.lik_mean).item(),
                         lik_sd=mathx.to_log10(pred.lik_var).item(),
                         prob=float(np.exp(self.ln_probs[i])),
                         log10_prob=mathx.to_log10(self.ln_probs[i]).item())
                if self.distances is not None:
                    o["dist_to_primary"] = self.distances[i]
                options.append(o)
            obj["options"] = options
        if self.warnings:
            obj["warnings"] = self.warnings
        return obj


def run_filter(genotypes: np.ndarray, priors: np.ndarray,
               best_aln_matrix: np.ndarray, filt_diff: float,
               out_size: int) -> np.ndarray:
    """Stage-0 filter on alignment likelihood alone (solve.rs:87-122):
    score(gt) = prior + Σ_r max_h∈gt best_aln[h, r].  genotypes [G, P]."""
    gt_best = best_aln_matrix[genotypes[:, 0]]                 # [G, R]
    for p in range(1, genotypes.shape[1]):
        gt_best = np.maximum(gt_best, best_aln_matrix[genotypes[:, p]])
    scores = priors + gt_best.sum(axis=1)
    return select_by_scores(scores, filt_diff, out_size)


def _stage_plato(stage: Stage) -> int:
    """Plateau budget (in annealer steps) for the parallel-chains walk.  Anneal stages: the reference's plato_size equals the polish
    budget (stoch.rs:164-167, the `p=` parameter sets both here).  Greedy
    stages: the reference counts ITERATIONS of `sample` examined reads
    (stoch.rs:95-133), so its plateau of `plato` iterations corresponds to
    plato x sample single-read steps of the polish walk."""
    if stage.kind == "anneal":
        return int(stage.polish_steps)
    return int(stage.plato) * max(int(stage.sample), 1)


def select_by_scores(scores: np.ndarray, filt_diff: float,
                     out_size: int) -> np.ndarray:
    """Selection half of the stage-0 filter: keep genotypes within
    `filt_diff` of the best, at least `out_size` (solve.rs:87-122)."""
    ixs = np.argsort(-scores, kind="stable")
    n = ixs.size
    if out_size >= n:
        return ixs
    thresh = scores[ixs[0]] - filt_diff
    m = int(np.searchsorted(-scores[ixs], -thresh, side="right"))
    if m < out_size:
        thresh = scores[ixs[out_size - 1]]
        m = int(np.searchsorted(-scores[ixs], -thresh, side="right"))
    m = min(max(m, 1), n)
    logger.debug("    Filter: keep %d/%d genotypes (%.1f%%)", m, n, 100.0 * m / n)
    return ixs[:m]


def discard_improbable(ixs: np.ndarray, predictions: dict, genotypes,
                       prob_thresh: float, out_size: int) -> np.ndarray:
    """(solve.rs:415-470)."""
    n = ixs.size
    if out_size >= n:
        return ixs
    order = sorted(ixs.tolist(), key=lambda i: -predictions[i].lik_mean)
    best = predictions[order[0]]
    new_ixs = order[:out_size]
    if out_size <= 500:
        dropped = 0
        for ix in order[out_size:]:
            ln_pval = compare_two_likelihoods(predictions[ix], best)
            if ln_pval >= prob_thresh:
                new_ixs.append(ix)
            else:
                dropped += 1
                if dropped >= 5:
                    break
    logger.debug("    Keep %d/%d genotypes after culling", len(new_ixs), n)
    return np.array(new_ixs)


def produce_result(ixs, predictions: dict, genotypes, tag: str,
                   total_reads: int, params: Params) -> Genotyping:
    """(solve.rs:472-524)."""
    THRESH = np.log(1e-5)
    MAX_GENOTYPES = 50
    min_output = max(4, params.out_bams, params.out_sams)
    thresh_prob = min(THRESH, params.prob_thresh)
    order = sorted(ixs.tolist(), key=lambda i: -predictions[i].lik_mean)
    n = min(len(order), MAX_GENOTYPES)
    ln_probs = np.zeros(n)
    out_gts, preds = [], []
    i = 0
    while i < n:
        pred_i = predictions[order[i]]
        out_gts.append(tuple(genotypes[order[i]]))
        for j in range(i + 1, n):
            pred_j = predictions[order[j]]
            prob_j = compare_two_likelihoods(pred_j, pred_i)
            if i == 0 and j >= min_output and prob_j < thresh_prob:
                n = j
                break
            ln_probs[i] += np.log1p(-min(np.exp(prob_j), 1.0 - 1e-15))
            ln_probs[j] += prob_j
        preds.append(pred_i)
        i += 1
    ln_probs = ln_probs[:n]
    norm = mathx.ln_sum(ln_probs)
    ln_probs = ln_probs - norm
    quality = (min(mathx.phred_from_ln_prob(mathx.ln_sum(ln_probs[1:])), 1e9)
               if n > 1 else 0.0)
    return Genotyping(tag=tag, genotypes=out_gts, ln_probs=ln_probs,
                      predictions=preds, quality=float(quality),
                      total_reads=total_reads)


def _unpermute_assignments(assgns, gts, tensors, params):
    """assgns [Gc, A, R] in permuted slots -> original slots (the
    permutation is deterministic: valid-first stable order)."""
    out = np.empty_like(assgns)
    for gi, gt in enumerate(gts):
        ps = [tensors.hap_prob[int(h)] for h in gt]
        unm = (tensors.unmapped_prob if tensors.unmapped_prob.ndim == 1
               else tensors.unmapped_prob[int(gt[0])])
        probs = np.concatenate(ps + [unm[:, None]], 1)
        best = unm
        for p in ps:
            best = np.maximum(best, p.max(1))
        valid = probs >= (best - params.prob_diff)[:, None]
        vorder = np.argsort(~valid, axis=-1, kind="stable")
        R = probs.shape[0]
        for a in range(assgns.shape[1]):
            out[gi, a] = vorder[np.arange(R), assgns[gi, a]]
    return out


def _gt_chunks(total: int, cap: int) -> list:
    """Chunk plan [(start, take)] for a genotype list: at most `cap`
    genotypes per annealer call (bounds the per-call device tensors)."""
    return [(start, min(cap, total - start))
            for start in range(0, total, max(cap, 1))]


def _candidate_k_cap(tensors, ploidy: int) -> int | None:
    """Cap on live candidate slots for the annealer's valid-first-permuted
    feeds: every read has at most `max_v` non-NEG slots per haplotype (host
    count over tensors.hap_prob — an upper bound on _gather_candidates'
    post-prob_diff valid set), so after the valid-first permutation all
    live candidates sit below P*max_v + 1.  Slicing there shrinks the
    per-chain feeds without changing any walk (the random stream does not
    depend on K).  None = no win."""
    k_full = ploidy * tensors.kh + 1
    if tensors.hap_prob.size == 0:
        return None
    max_v = int((np.asarray(tensors.hap_prob) > NEG / 2).sum(axis=2).max())
    k_eff = ploidy * max_v + 1
    return k_eff if k_eff < k_full else None


def _resolve_engine(stage: Stage, mesh) -> str:
    """The engine that runs `stage`: "seq" or "chains"."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-GPU solving (mesh) is not ported yet — ROADMAP.md A12")
    if stage.engine == "seq":
        return "seq"
    if stage.engine in ("auto", "chains", "pallas"):
        return "chains"
    if stage.engine == "batched":
        raise NotImplementedError(
            "solver engine 'batched' is not part of this package — "
            "ROADMAP.md 'Do not port'")
    raise ValueError(f"Unknown solver engine {stage.engine!r}")


def _device_solver_args(tensors, pack, bayes, device):
    """The 9 array operands every stage call passes to the annealer, moved
    to the device ONCE per solve."""
    f32, i32 = torch.float32, torch.int32
    args = ((tensors.hap_prob, f32), (tensors.hap_mid, i32),
            (tensors.unmapped_prob, f32), (pack.n_windows, i32),
            (pack.reg_start, i32), (pack.contig_len, i32),
            (pack.gc_at, i32), (pack.weight_at, f32), (bayes, f32))
    return tuple(torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)
                 for a, dt in args)


def solve_locus(tensors: LocusTensors, pack: ContigInfoPack, bg_distr,
                genotypes: np.ndarray, priors: np.ndarray, params: Params,
                scheme: Scheme, seed: int, tag: str = "locus",
                dist_matrix: np.ndarray | None = None,
                gt_batch: int = GT_BATCH, sol_writer=None,
                gt_names=None, mesh=None, device=None) -> Genotyping:
    """Full multi-stage solve of one locus: a panel of one (`solve_panel`).

    sol_writer: optional text stream receiving per-stage scores
    ("stage\\tgenotype\\tscore", counterpart of sol.csv.gz, solve.rs:918-919).
    device: None = CUDA (raises without one); "cpu" = the CPU.
    """
    item = PanelItem(tensors=tensors, pack=pack, genotypes=genotypes,
                     priors=priors, tag=tag, dist_matrix=dist_matrix,
                     sol_writer=sol_writer, gt_names=gt_names)
    return _solve_panel_group([item], bg_distr, params, scheme, seed,
                              gt_batch, mesh, device)[0]


# ---------------------------------------------------------------------------
# Multi-locus panel solving: all loci in shared annealer calls
# ---------------------------------------------------------------------------

@dataclass
class PanelItem:
    """One locus's solver inputs for `solve_panel`."""
    tensors: object                  # LocusTensors
    pack: object                     # ContigInfoPack
    genotypes: np.ndarray            # [G, P] local hap ids
    priors: np.ndarray               # [G]
    tag: str = "locus"
    dist_matrix: np.ndarray | None = None
    sol_writer: object = None
    gt_names: list | None = None


def _combine_panel(items):
    """Concatenates per-locus tensors along the haplotype axis with a SHARED
    read axis [R_max]: each locus's haplotype rows carry its own reads
    (rows beyond its read count stay NEG/-1/0 — trivial, contributing 0,
    exactly like LocusTensors.build's dummy reads).  unmapped_prob becomes
    [H_tot, R_max] per-haplotype rows.  Genotype hap ids shift by per-locus
    offsets.  Returns (tensors, pack, hap offsets)."""
    R_max = max(it.tensors.hap_prob.shape[1] for it in items)
    kh = max(it.tensors.kh for it in items)
    H_tot = sum(it.tensors.n_haps for it in items)
    max_len = max(it.pack.max_len for it in items)
    max_windows = max(it.pack.max_windows for it in items)
    wsize = items[0].pack.window_size
    if any(it.pack.window_size != wsize for it in items):
        raise ValueError("loci of one combined solve must share a window size")

    hap_prob = np.full((H_tot, R_max, kh), NEG, np.float32)
    hap_mid = np.full((H_tot, R_max, kh, 2), -1, np.int32)
    unm = np.zeros((H_tot, R_max), np.float32)
    gc_at = np.zeros((H_tot, max_len), np.int32)
    weight_at = np.zeros((H_tot, max_len), np.float32)
    n_windows = np.zeros(H_tot, np.int32)
    reg_start = np.zeros(H_tot, np.int32)
    contig_len = np.zeros(H_tot, np.int32)
    offsets = []
    off = 0
    for it in items:
        t, p = it.tensors, it.pack
        H, R, K = t.hap_prob.shape
        hap_prob[off:off + H, :R, :K] = t.hap_prob
        hap_mid[off:off + H, :R, :K] = t.hap_mid
        unm[off:off + H, :R] = t.unmapped_prob[None, :]
        gc_at[off:off + H, :p.max_len] = p.gc_at
        weight_at[off:off + H, :p.max_len] = p.weight_at
        n_windows[off:off + H] = p.n_windows
        reg_start[off:off + H] = p.reg_start
        contig_len[off:off + H] = p.contig_len
        offsets.append(off)
        off += H
    tensors = LocusTensors(hap_prob, hap_mid, unm, H_tot, R_max, kh)
    pack = ContigInfoPack(
        n_haps=H_tot, max_len=max_len, max_windows=max_windows,
        n_windows=n_windows, reg_start=reg_start, contig_len=contig_len,
        window_size=wsize, gc_at=gc_at, weight_at=weight_at)
    return tensors, pack, offsets


def solve_panel(items: list, bg_distr, params: Params, scheme: Scheme,
                seed: int, gt_batch: int = GT_BATCH, mesh=None,
                device=None) -> list:
    """Multi-stage solve of SEVERAL loci in shared annealer calls: every
    stage runs the combined genotype list of all loci through one call per
    chunk, so that small per-locus genotype counts still fill the device.
    Per-locus semantics — stage-0 filter, stage skipping, culling, ranking
    — stay independent and match `solve_locus`.

    Loci whose contigs were windowed at different sizes (different read
    lengths at preproc time) cannot share one combined program — they are
    bucketed by window size and each bucket is solved on its own.

    seed: integer; every stage chunk derives its own generator seed from
    (seed, stage, chunk start).  device: None = CUDA (raises without one);
    "cpu" = the CPU.  Returns list[Genotyping] in `items` order.
    """
    sizes = [it.pack.window_size for it in items]
    if len(set(sizes)) > 1:
        logger.info("    Panel spans %d window sizes — solving one combined "
                    "program per size bucket", len(set(sizes)))
        results: list = [None] * len(items)
        for b_ix, ws in enumerate(sorted(set(sizes))):
            sub = [li for li, s in enumerate(sizes) if s == ws]
            sub_res = _solve_panel_group(
                [items[li] for li in sub], bg_distr, params, scheme,
                derive_seed(seed, "bucket", b_ix), gt_batch, mesh, device)
            for li, r in zip(sub, sub_res):
                results[li] = r
        return results
    return _solve_panel_group(items, bg_distr, params, scheme, seed,
                              gt_batch, mesh, device)


def _solve_panel_group(items: list, bg_distr, params: Params, scheme: Scheme,
                       seed: int, gt_batch: int, mesh, device) -> list:
    """One combined multi-stage program over loci sharing a window size
    (`solve_panel` body; see its docstring)."""
    engines = [_resolve_engine(stage, mesh) for stage in scheme.stages]
    dev = _kernels.resolve_device(device)
    n_loci = len(items)
    t_c0 = time.monotonic()
    tensors, pack, offsets = _combine_panel(items)
    mul_coef = 2.0 if bg_distr.insert_distr.is_paired_end else 1.0
    bayes = build_bayes_table(bg_distr.depth.distributions,
                              list(params.alt_cn), mul_coef)
    dev_args = _device_solver_args(tensors, pack, bayes, dev)
    k_cap = _candidate_k_cap(tensors, int(items[0].genotypes.shape[-1]))
    logger.debug("    combine+upload: %.2fs (R=%d, W=%d)",
                 time.monotonic() - t_c0, tensors.n_reads,
                 pack.max_windows)

    def write_sol(it, stage_ix, ix, score):
        if it.sol_writer is not None:
            name = (it.gt_names[ix] if it.gt_names
                    else f"{it.genotypes[ix]}")
            it.sol_writer.write(
                f"{stage_ix}\t{name}\t{mathx.to_log10(score):.4f}\n")

    # Per-locus stage-0 filter (host; pure alignment likelihood).
    ixs_per: list[np.ndarray] = []
    for it in items:
        t = it.tensors
        n_real = t.n_reads
        best_aln = np.maximum(t.hap_prob[:, :n_real].max(axis=2),
                              t.unmapped_prob[None, :n_real])
        ixs_per.append(run_filter(it.genotypes, it.priors, best_aln,
                                  params.filt_diff,
                                  scheme.stages[0].in_size))

    preds_per: list[dict] = [{} for _ in items]
    seed_rows: dict = {}    # (locus, ix) -> permuted best row (init=prev)
    n_stages = len(scheme.stages)
    for s_ix, stage in enumerate(scheme.stages):
        out_size = (scheme.stages[s_ix + 1].in_size
                    if s_ix + 1 < n_stages else None)
        # Per-locus stage skipping (solve.rs: skip when not enough gts).
        active = [li for li in range(n_loci)
                  if params.dont_skip or out_size is None
                  or out_size < ixs_per[li].size]
        if not active:
            logger.info("    Skipping stage %d for all loci", s_ix + 1)
            continue
        t0 = time.monotonic()
        engine = engines[s_ix]
        random_init = stage.kind == "anneal"
        cfg = SolverConfig(
            anneal_steps=stage.anneal_steps,
            polish_steps=stage.polish_steps,
            depth_contrib=params.depth_contrib,
            aln_contrib=params.aln_contrib,
            prob_diff=params.prob_diff,
            tweak=int(params.tweak or 0),
            window_size=pack.window_size,
            greedy_sample=(stage.sample
                           if stage.kind == "greedy" and engine == "seq"
                           else 0),
            plato_size=stage.plato,
        )
        final_stage = out_size is None
        # init=prev seeding (chains engine): the NEXT stage wants this
        # stage's best assignments (permuted slot space) as warm starts.
        next_seed = (not final_stage and engine == "chains"
                     and scheme.stages[s_ix + 1].seed_prev)

        # Combined genotype list over the active loci.
        rows = []                # (locus, local gt ix)
        g_parts = []
        for li in active:
            gts_local = items[li].genotypes[ixs_per[li]]
            g_parts.append(gts_local.astype(np.int64) + offsets[li])
            rows.extend((li, int(ix)) for ix in ixs_per[li])
        all_gts = np.concatenate(g_parts)

        # Two-phase chunk pipeline: launch EVERY chunk (the device queues
        # them back to back), then fetch and digest in order.  Non-final
        # stages only rank by likelihood, so their [G, A, R] assignments
        # stay on the device unless the next stage seeds from them.
        pend = []
        for st, take in _gt_chunks(all_gts.shape[0], gt_batch):
            chunk_rows = rows[st:st + take]
            gts = all_gts[st:st + take]
            stage_seed = derive_seed(seed, s_ix * 100003 + st)
            if engine == "seq":
                # The reference's seq branch: no k_eff, no plateau polish,
                # no warm start (solvers/solve.py:765-806).
                liks, assgns = seq_solver.solve_genotypes(
                    stage_seed, gts, *dev_args, cfg,
                    n_attempts=stage.attempts, max_windows=pack.max_windows,
                    random_init=random_init, device=dev)
            else:
                init_ = None
                if stage.seed_prev and all(k in seed_rows
                                           for k in chunk_rows):
                    init_ = np.stack([seed_rows[k] for k in chunk_rows])
                    init_ = np.repeat(init_[:, None, :], stage.attempts, 1)
                liks, assgns = solver_chains.solve_genotypes(
                    stage_seed, gts, *dev_args, cfg,
                    n_attempts=stage.attempts, max_windows=pack.max_windows,
                    n_steps=cfg.anneal_steps + cfg.polish_steps,
                    random_init=random_init, k_eff=k_cap,
                    plato=_stage_plato(stage), init_assgn=init_, device=dev)
            pend.append((chunk_rows, gts, liks,
                         assgns if final_stage or next_seed else None))
        seed_rows = {}
        n_gts = 0
        for chunk_rows, gts, liks, assgns in pend:
            liks = liks.cpu().numpy().astype(np.float64)
            if assgns is not None:
                assgns = assgns.cpu().numpy()
                if next_seed:
                    # Keep the best attempt's PERMUTED row per genotype
                    # for the next stage's warm start.
                    best_a = np.argmax(liks, axis=1)
                    for gi, k in enumerate(chunk_rows):
                        seed_rows[k] = assgns[gi, best_a[gi]]
                if final_stage and engine == "chains":
                    # The annealer's assignments live in the valid-first
                    # permuted slot space; map back to candidate slots (the
                    # seq engine returns candidate slots).
                    assgns = _unpermute_assignments(assgns, gts, tensors,
                                                    params)
            for gi, (li, ix) in enumerate(chunk_rows):
                it = items[li]
                row = liks[gi] + it.priors[ix]
                mean, var = mathx.mean_variance(row)
                preds_per[li][ix] = Prediction(
                    mean, var, stage.attempts,
                    assignments=assgns[gi] if final_stage else None)
                write_sol(it, s_ix + 1, ix, mean)
            n_gts += len(chunk_rows)
        dt = time.monotonic() - t0
        logger.info("    Stage %d (%s): %d loci, %d genotypes x %d attempts "
                    "in %.2fs (%.4f s/gt)", s_ix + 1, stage.kind,
                    len(active), n_gts, stage.attempts, dt,
                    dt / max(n_gts, 1))
        if out_size is not None:
            for li in active:
                ixs_per[li] = discard_improbable(
                    ixs_per[li], preds_per[li], items[li].genotypes,
                    params.prob_thresh, out_size)

    results = []
    for li, it in enumerate(items):
        result = produce_result(ixs_per[li], preds_per[li], it.genotypes,
                                it.tag, it.tensors.n_reads, params)
        if it.dist_matrix is not None and result.genotypes:
            dists = [0.0 if i == 0 else
                     genotype_distance(result.genotypes[0], gt,
                                       it.dist_matrix)
                     for i, gt in enumerate(result.genotypes)]
            probs = np.exp(result.ln_probs)
            result.weighted_dist = float(
                np.sum(probs * np.array(dists))
                / max(np.sum(probs), 1e-300))
            result.distances = dists
        results.append(result)
    return results
