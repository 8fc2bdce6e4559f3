"""The read-assignment annealer: C = G×attempts independent chains.

Counterpart of the reference package's `ops/solver_pallas.py`
(`_prepare_chains`, `_kernel`, `solve_genotypes_pallas`).  Per step every
chain picks a random non-trivial read and a random other valid candidate of
it, computes Δ = ac·Δaln + dc·Σ of ≤4 window-depth deltas (shared-window
cascade, assgn.rs:259-284), and accepts by Metropolis under linear cooling
for `anneal_steps`, then by strict improvement (polish).  An optional
plateau freezes a chain after `plato` consecutive rejected moves
(stoch.rs:196-240).  The final likelihood is recomputed from the end state.

Layout is chain-major (a chain's rows are contiguous); probabilities and
validity counts depend on the genotype only and are shared by its attempts:
  probs   [G, R, K] f32   candidate ln-probs, valid candidates permuted to
                          slots [0, vcount)
  winpk   [C, R, K] i32   window pair packed w1 | w2 << 16
  wtab    [C, W, D] f32   weight·lnBayes(depth), D = d_tab
  vcount, nt_ixs [G, R]; ntc, start_temp [G]
  state:  assgn [C, R] i32, depth [C, W] i32,
          cache [C, W] f32 = wtab at the CURRENT depth of each window

Randomness is a counter-based generator, Philox4x32-10, keyed by the call's
seed and counted by (chain, step): word 0 picks the read, word 1 the
candidate, word 2 is the acceptance draw.  It is written twice — in PyTorch
integer ops here and in CUDA in `csrc/anneal_chains.cu` — so that the plain
annealer `anneal_chains_reference` and the kernel consume the same stream.
The kernel walks a chain 32 steps at a time (one warp a chain, one lane a
step, moves resolved in order); its results equal the step-by-step plain
version's to the bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import _kernels
from ..utils import spans
from .solver import (NEG, SolverConfig, _compact_valid, _gather_candidates,
                     _read_windows, _window_tables)

M16 = 0xFFFF

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_M32 = 0xFFFFFFFF


def _mulhilo32(a: int, b):
    """(hi, lo) 32-bit halves of a·b for a constant a < 2^32 and an int64
    tensor b < 2^32, without overflowing int64."""
    lo16 = a * (b & 0xFFFF)                 # < 2^48
    hi16 = a * (b >> 16)                    # < 2^48
    lo = (lo16 + ((hi16 & 0xFFFF) << 16)) & _M32
    hi = (hi16 + (lo16 >> 16)) >> 16
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al. 2011) on int64 tensors holding 32-bit
    words; returns the four output words as int64 tensors in [0, 2^32)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def _u01(bits):
    """Uniform [0,1) f32 from the top 24 bits of a 32-bit word."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _randint(u, bound):
    """Uniform integers in [0, bound) from u in [0,1) (bound int64 > 0)."""
    return torch.minimum((u * bound.to(torch.float32)).to(torch.int64),
                         bound - 1)


def _split_seed(seed: int):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, seed >> 32


def anneal_chains_reference(probs, winpk, vcount, nt_ixs, ntc, start_temp,
                            wtab, assgn0, depth0, cache0, *, attempts: int,
                            n_steps: int, anneal_steps: int, dc: float,
                            ac: float, plato: int = 0,
                            ln_init_prob: float = -0.6931472, seed: int = 0):
    """Plain PyTorch annealer: vectorised over chains, Python loop over
    steps.  Same function, step for step, as the CUDA kernel.  Returns
    (lik [C] f32, assgn [C, R] i32, steps_done [C] i32 — the moves each
    chain proposed before it froze or ran out of steps); the inputs are not
    modified."""
    C, R, K = winpk.shape
    W, D = wtab.shape[1], wtab.shape[2]
    dev = probs.device
    i64, f32 = torch.int64, torch.float32
    plato = plato if plato and plato < n_steps else 0

    cix = torch.arange(C, device=dev, dtype=i64)
    g = cix // attempts
    probs_f = probs.reshape(-1)
    winpk_f = winpk.reshape(-1)
    wtab_f = wtab.reshape(-1)
    vcount_f = vcount.reshape(-1).to(i64)
    nt_f = nt_ixs.reshape(-1).to(i64)
    ntc_c = ntc.to(i64)[g]
    st = start_temp.to(f32)[g]
    assgn = assgn0.to(i64).clone()
    depth = depth0.to(i64).clone()
    # One spare column receives the writes of windows whose depth does not
    # change, so that one scatter serves all four windows of a move.
    cache = torch.cat([cache0.to(f32),
                       torch.zeros((C, 1), dtype=f32, device=dev)], dim=1)
    stale = torch.zeros(C, dtype=i64, device=dev)
    steps_done = torch.full((C,), 0 if plato else n_steps, dtype=i64,
                            device=dev)
    if plato:
        min_diff = torch.clamp_min(st * float(np.float32(-ln_init_prob))
                                   * 1e-6, 1e-10)
    k0, k1 = _split_seed(seed)
    denom = float(max(anneal_steps, 1))
    zero = torch.zeros(C, dtype=i64, device=dev)
    block = int(min(max((1 << 22) // max(C, 1), 16), 1024))

    for s0 in range(0, n_steps, block):
        nb = min(block, n_steps - s0)
        steps = torch.arange(s0, s0 + nb, device=dev, dtype=i64)[:, None]
        b0, b1, b2, _ = philox4x32(cix[None, :].expand(nb, C),
                                   steps.expand(nb, C), zero, zero, k0, k1)
        u_t, u_i, u_a = _u01(b0), _u01(b1), _u01(b2)
        for ds in range(nb):
            s = s0 + ds
            t = _randint(u_t[ds], ntc_c)
            r = nt_f[g * R + t]
            cur = assgn[cix, r]
            vc = vcount_f[g * R + r]
            i = 1 + _randint(u_i[ds], torch.clamp_min(vc - 1, 1))
            new = torch.where(i <= cur, i - 1, i)
            gbase = (g * R + r) * K
            cbase = (cix * R + r) * K
            p_cur = probs_f[gbase + cur]
            p_new = probs_f[gbase + new]
            wp_cur = winpk_f[cbase + cur].to(i64)
            wp_new = winpk_f[cbase + new].to(i64)
            w1, w2 = wp_cur & M16, (wp_cur >> 16) & M16
            w3, w4 = wp_new & M16, (wp_new >> 16) & M16

            # Shared-window cascade (assgn.rs:259-284).
            e21 = w2 == w1
            c1 = -1 - e21.to(i64)
            c2 = e21.to(i64) - 1
            e31, e32 = w3 == w1, w3 == w2
            c3 = 1 - (e31 | e32).to(i64)
            c1 = c1 + e31.to(i64)
            c2 = c2 + (~e31 & e32).to(i64)
            e41, e42, e43 = w4 == w1, w4 == w2, w4 == w3
            c4 = 1 - (e41 | e42 | e43).to(i64)
            c1 = c1 + e41.to(i64)
            c2 = c2 + (~e41 & e42).to(i64)
            c3 = c3 + (~e41 & ~e42 & e43).to(i64)

            ws = torch.stack([w1, w2, w3, w4], dim=1)            # [C, 4]
            cs = torch.stack([c1, c2, c3, c4], dim=1)
            d0 = torch.gather(depth, 1, ws)
            cur_v = torch.gather(cache, 1, ws)
            d1 = torch.clamp(d0 + cs, 0, D - 1)
            new_v = wtab_f[(cix[:, None] * W + ws) * D + d1]
            moved = cs != 0
            dd = torch.where(moved, new_v - cur_v, 0.0)
            delta = ac * (p_new - p_cur) \
                + dc * (dd[:, 0] + dd[:, 1] + dd[:, 2] + dd[:, 3])

            s_rem = float(max(anneal_steps - s, 0))
            temp = st * s_rem / denom
            if plato:
                diffm = delta - min_diff
                metro = (temp > 0) & (u_a[ds] <= torch.exp(
                    diffm / torch.clamp_min(temp, 1e-30)))
                if s < anneal_steps:
                    accept = (diffm >= 0) | metro
                else:
                    accept = delta > min_diff
                live = stale < plato
                steps_done += live
                accept = accept & live
                stale = torch.where(accept, 0, stale + 1)
            else:
                metro = (temp > 0) & (u_a[ds] <= torch.exp(
                    delta / torch.clamp_min(temp, 1e-30)))
                accept = (delta >= 0) | metro

            inc = accept.to(i64)
            depth.scatter_add_(1, ws, torch.stack([-inc, -inc, inc, inc], 1))
            upd = moved & accept[:, None]
            cache.scatter_(1, torch.where(upd, ws, W), new_v)
            assgn[cix, r] = torch.where(accept, new, cur)
            if plato and (s & 127) == 127 and bool((stale >= plato).all()):
                break
        else:
            continue
        break

    # Final likelihood from the end state, summed in float64 and rounded
    # once so that the value does not depend on the order of summation.
    dep = cache[:, :W].double().sum(dim=1).to(f32)
    aln = torch.gather(probs[g], 2, assgn[:, :, None])[:, :, 0] \
        .double().sum(dim=1).to(f32)
    lik = dc * dep + ac * aln
    return lik, assgn.to(torch.int32), steps_done.to(torch.int32)


def _anneal_chains_cuda(probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab,
                        assgn0, depth0, cache0, *, attempts, n_steps,
                        anneal_steps, dc, ac, plato, ln_init_prob, seed,
                        schedule=None):
    C, R, K = winpk.shape
    G = probs.shape[0]
    W, D = wtab.shape[1], wtab.shape[2]
    dev = probs.device
    want = dict(probs=(probs, torch.float32, (G, R, K)),
                winpk=(winpk, torch.int32, (C, R, K)),
                vcount=(vcount, torch.int32, (G, R)),
                nt_ixs=(nt_ixs, torch.int32, (G, R)),
                ntc=(ntc, torch.int32, (G,)),
                start_temp=(start_temp, torch.float32, (G,)),
                wtab=(wtab, torch.float32, (C, W, D)),
                assgn0=(assgn0, torch.int32, (C, R)),
                depth0=(depth0, torch.int32, (C, W)),
                cache0=(cache0, torch.float32, (C, W)))
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"anneal_chains: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected {dt} "
                             f"{shape} on {dev}")
    if C != G * attempts or W > M16 + 1:
        raise ValueError(f"anneal_chains: C={C} G={G} attempts={attempts} "
                         f"W={W}")
    if schedule is not None and (
            schedule.dtype != torch.int64 or tuple(schedule.shape) != (2,)
            or schedule.device != dev or not schedule.is_contiguous()):
        raise ValueError(f"anneal_chains: schedule is {schedule.dtype} "
                         f"{tuple(schedule.shape)} on {schedule.device}, "
                         f"expected torch.int64 (2,) on {dev}")
    probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab = (
        t.contiguous() for t in (probs, winpk, vcount, nt_ixs, ntc,
                                 start_temp, wtab))
    # The kernel walks its state in place: work on private copies.
    assgn = assgn0.clone(memory_format=torch.contiguous_format)
    depth = depth0.clone(memory_format=torch.contiguous_format)
    cache = cache0.clone(memory_format=torch.contiguous_format)
    lik = torch.empty((C,), dtype=torch.float32, device=dev)
    steps_done = torch.empty((C,), dtype=torch.int32, device=dev)
    plato = plato if plato and plato < n_steps else 0
    if C:
        lib = _kernels.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.anneal_chains_launch(
                probs.data_ptr(), winpk.data_ptr(), vcount.data_ptr(),
                nt_ixs.data_ptr(), ntc.data_ptr(), start_temp.data_ptr(),
                wtab.data_ptr(), assgn.data_ptr(), depth.data_ptr(),
                cache.data_ptr(), lik.data_ptr(), steps_done.data_ptr(),
                C, R, K, W, D, int(attempts), int(n_steps),
                int(anneal_steps), int(plato), float(dc), float(ac),
                float(ln_init_prob), int(seed) & 0x7FFFFFFFFFFFFFFF,
                None if schedule is None else schedule.data_ptr(), stream)
        _kernels.check(err, "anneal_chains")
        _kernels.LAUNCHES["anneal_chains"] += 1
    return lik, assgn, steps_done


def anneal_chains(probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab,
                  assgn0, depth0, cache0, *, attempts: int, n_steps: int,
                  anneal_steps: int, dc: float, ac: float, plato: int = 0,
                  ln_init_prob: float = -0.6931472, seed: int = 0,
                  schedule=None):
    """Kernel wrapper: CUDA tensors go to the hand-written kernel (or
    raise), CPU tensors to the plain version — decided by where `probs`
    lies and by nothing else.  Returns (lik [C], assgn [C, R] int32,
    steps_done [C] int32).

    `schedule`, if given, is an int64 tensor of two elements beside `probs`
    on the card: the kernel adds to it the evaluation rounds and the batches
    of 32 steps of this launch's chains (rounds / batches is 1 when no move
    of a batch disturbs a later one, and at most 32).  The plain version
    walks step by step and has no such account: with CPU tensors `schedule`
    must be None.  The chains, C, go to the call's counter `k2_chains` on
    either device (utils/spans.py); a CUDA launch, one for any C > 0, to
    `_kernels.LAUNCHES`."""
    kw = dict(attempts=attempts, n_steps=n_steps, anneal_steps=anneal_steps,
              dc=dc, ac=ac, plato=plato, ln_init_prob=ln_init_prob,
              seed=int(seed) & 0x7FFFFFFFFFFFFFFF)
    spans.count("k2_chains", winpk.shape[0])
    if probs.is_cuda:
        return _anneal_chains_cuda(probs, winpk, vcount, nt_ixs, ntc,
                                   start_temp, wtab, assgn0, depth0, cache0,
                                   schedule=schedule, **kw)
    if schedule is not None:
        raise ValueError("anneal_chains: schedule is counted by the CUDA "
                         "kernel only")
    return anneal_chains_reference(probs, winpk, vcount, nt_ixs, ntc,
                                   start_temp, wtab, assgn0, depth0, cache0,
                                   **kw)


def _prepare_chains(gen, genotypes, attempts, hap_prob, hap_mid,
                    unmapped_prob, pack_nwin, pack_regstart, pack_len, gc_at,
                    weight_at, bayes, cfg: SolverConfig, max_windows: int,
                    random_init: bool, k_eff: int | None = None,
                    init_assgn=None):
    """Builds the per-chain tensors of `anneal_chains` (once per stage call).

    The candidate gather/permute depends only on the GENOTYPE and is done
    once per genotype; only the randomly-tweaked window tables and the
    chain init are per-attempt (the generator-dependent part)."""
    D = cfg.d_tab
    dev = hap_prob.device
    G = genotypes.shape[0]
    C = G * attempts
    probs, mids, slots, valid = _gather_candidates(
        hap_prob, hap_mid, unmapped_prob, genotypes, cfg.prob_diff)
    vorder, vcount = _compact_valid(valid)
    vo = vorder.long()
    probs_p = torch.gather(probs, 2, vo)
    mids_p = torch.gather(mids, 2, vo[..., None].expand(-1, -1, -1, 2))
    slots_p = torch.gather(slots, 2, vo)
    if k_eff is not None and k_eff < probs_p.shape[-1]:
        # Valid-first permutation: every valid candidate sits below the
        # host-computed cap (solve.py _candidate_k_cap), so the dropped
        # tail is all-NEG padding.
        probs_p = probs_p[:, :, :k_eff]
        mids_p = mids_p[:, :, :k_eff]
        slots_p = slots_p[:, :, :k_eff]
    nontrivial = vcount > 1
    ntc = torch.clamp_min(nontrivial.sum(dim=1), 1).to(torch.int32)
    nt_ixs = torch.argsort((~nontrivial).to(torch.uint8), dim=1,
                           stable=True).to(torch.int32)
    live = probs_p > NEG / 2
    spread = torch.where(live, probs_p, -math.inf).amax(dim=2) \
        - torch.where(live, probs_p, math.inf).amin(dim=2)
    spread = torch.where(torch.isfinite(spread), spread, -math.inf)
    mx = spread.amax(dim=1)
    mx = torch.where(torch.isfinite(mx), mx, 1.0)
    max_abs = mx * cfg.aln_contrib + 10.0
    start_temp = torch.clamp_min(-max_abs / math.log(cfg.init_prob), 1e-5)

    def rep(x):
        return torch.repeat_interleave(x, attempts, dim=0)

    gts_rep = rep(genotypes)
    win_gc, win_weight = _window_tables(
        gen, gts_rep, pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
        cfg.window_size, cfg.tweak, max_windows)
    wins = _read_windows(gen, gts_rep, rep(mids_p), rep(slots_p), pack_nwin,
                         pack_regstart, cfg.window_size, cfg.tweak,
                         max_windows)
    winpk = wins[..., 0] | (wins[..., 1] << 16)
    wtab = win_weight[:, :, None] * bayes[:, :D][win_gc]          # [C, W, D]
    vcount_c = rep(vcount)
    if init_assgn is not None:
        # Caller-provided warm start (e.g. the previous stage's best
        # assignment, permuted slot space); clipped to the valid set.
        assgn0 = torch.minimum(
            torch.clamp_min(init_assgn.reshape(C, -1).to(torch.int32), 0),
            torch.clamp_min(vcount_c - 1, 0))
    elif random_init:
        u = torch.rand(vcount_c.shape, generator=gen, device=dev,
                       dtype=torch.float32)
        assgn0 = torch.minimum((u * vcount_c).to(torch.int32),
                               torch.clamp_min(vcount_c - 1, 0))
    else:
        assgn0 = rep(torch.argmax(probs_p, dim=2).to(torch.int32))
    wp0 = torch.gather(winpk, 2, assgn0.long()[:, :, None])[:, :, 0]
    W = wtab.shape[1]
    depth0 = torch.zeros((C, W), dtype=torch.int32, device=dev)
    ones = torch.ones(wp0.shape, dtype=torch.int32, device=dev)
    depth0.scatter_add_(1, (wp0 & M16).long(), ones)
    depth0.scatter_add_(1, ((wp0 >> 16) & M16).long(), ones)
    cache0 = torch.gather(wtab, 2, torch.clamp(depth0, 0, D - 1)
                          .long()[:, :, None])[:, :, 0]
    return (probs_p.contiguous(), winpk.contiguous(), vcount, nt_ixs, ntc,
            start_temp, wtab, assgn0.contiguous(), depth0, cache0)


def solve_genotypes(seed: int, genotypes, hap_prob, hap_mid, unmapped_prob,
                    pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
                    bayes, cfg: SolverConfig, n_attempts: int,
                    max_windows: int, n_steps: int | None = None,
                    random_init: bool = True, k_eff: int | None = None,
                    plato: int = 0, init_assgn=None, device=None):
    """Evaluates a batch of genotypes with `n_attempts` chains each.

    genotypes: [G, P] haplotype ids.  The array arguments may be numpy
    arrays or tensors; they are moved to `device` (None = CUDA, raises
    without one; "cpu" = the plain annealer).
    Returns (liks [G, A] f32, assignments [G, A, R] int32 in PERMUTED slot
    space — see _prepare_chains; use liks for ranking) on `device`.

    init_assgn: optional [G, A, R] warm-start assignments in the SAME
    permuted slot space that is returned (stage-to-stage seeding — slot
    permutations are deterministic per genotype, so a previous stage's
    output rows feed directly)."""
    dev = _kernels.resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    genotypes = put(genotypes, torch.int64)
    hap_prob, unmapped_prob, weight_at, bayes = (
        put(x, torch.float32) for x in (hap_prob, unmapped_prob, weight_at,
                                        bayes))
    hap_mid, pack_nwin, pack_regstart, pack_len, gc_at = (
        put(x, torch.int32) for x in (hap_mid, pack_nwin, pack_regstart,
                                      pack_len, gc_at))
    if init_assgn is not None:
        init_assgn = put(init_assgn, torch.int32)
    G = genotypes.shape[0]
    n_steps = (cfg.anneal_steps + cfg.polish_steps) if n_steps is None \
        else n_steps
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    (probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab, assgn0, depth0,
     cache0) = _prepare_chains(
        gen, genotypes, n_attempts, hap_prob, hap_mid, unmapped_prob,
        pack_nwin, pack_regstart, pack_len, gc_at, weight_at, bayes, cfg,
        max_windows, random_init, k_eff=k_eff, init_assgn=init_assgn)
    lik, assgn, _steps = anneal_chains(
        probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab, assgn0, depth0,
        cache0, attempts=n_attempts, n_steps=n_steps,
        anneal_steps=cfg.anneal_steps, dc=float(cfg.depth_contrib),
        ac=float(cfg.aln_contrib), plato=plato,
        ln_init_prob=float(np.log(cfg.init_prob)), seed=seed)
    R = assgn.shape[1]
    return lik.reshape(G, n_attempts), assgn.reshape(G, n_attempts, R)
