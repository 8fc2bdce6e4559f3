"""What decides `correct`: the timed path's outputs, taken by probes on
the program's functions during the window, held after it against the plain
reference (`reference.py`) and against the simulated truth.

Numbers compared, each with its limit in `limits/<cell>.json`:

* `recruit_diff`: pairs (single reads) recruited to a locus by the program
  and not by the reference, or the other way round, summed over the
  window's calls.
* `align_diff`: jobs of a seed-drawn sample of every alignment launch whose
  outputs differ from the reference aligner's on the same job, or whose
  read is neither strand of a mate of a pair (of a single read) the
  reference recruited in that sample, or whose window is not a stretch of
  a panel haplotype.
* `lik_gap`: the largest gap, relative to its size, between the likelihood
  the annealer returned for a seed-drawn chain and the reference's
  re-scoring of the end state it returned.
* `unpolished_share`: of the seed-drawn chains of annealing launches that
  have a read with a second candidate, the share whose end state one read's
  move would still raise by more than `STEP_UP`: every such launch ends in
  a polish of strict improvements until the chain freezes, so a sound
  annealer leaves none; with no such chain sampled, 1.
* `wrong_call_share`: of the loci of every completed call (the window's
  and, where it runs, the set-up's command-line process), the share whose
  `res.json.gz`
  names another genotype than the sample's truth, or is missing.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import gen, reference
from .trace import patch

NAMES = ("recruit_diff", "align_diff", "lik_gap", "unpolished_share",
         "wrong_call_share")
JOBS_PER_LAUNCH = 16
#: Bytes of reads and windows the reference aligner takes in one pass.
ALIGN_BLOCK_BYTES = 1 << 30
CHAINS_PER_LAUNCH = 2
#: ln-likelihood a move must add to count as a step up: far above the
#: float32 rounding of the kernel's incremental sums.
STEP_UP = 1e-3


class Probe:
    """Wraps `_save_recruited`, `align_banded` and `anneal_chains` of the
    program and keeps, per call: the recruited names by locus, a sample of
    every alignment launch's jobs with their outputs, and a sample of every
    annealer launch's chains with their inputs and end states.  The
    samples are drawn on the launch's device from a generator seeded by the
    run's seed, and queued behind the launch: the probes add no
    synchronisation to the window."""

    def __init__(self, seed):
        self.seed = gen.rng_for(seed, 99).integers(2**62)
        self.generators = {}
        self.call = None            # index of the call in the window
        self.recruited = {}         # call -> {locus: [names]}
        self.jobs = []              # (call, inputs..., outputs)
        self.chains = []            # (call, inputs and outputs of chains)
        self._stack = None

    def _pick(self, n, m, device):
        """min(n, m) distinct indices below n, ascending, on `device`."""
        g = self.generators.get(device)
        if g is None:
            g = self.generators[device] = torch.Generator(device=device)
            g.manual_seed(int(self.seed))
        u = torch.rand(n, generator=g, device=device)
        return torch.topk(u, min(n, m)).indices.sort().values

    def _save_recruited(self, save):
        def save_recruited(ldir, pairs, names):
            self.recruited.setdefault(self.call, {})[Path(ldir).name] = \
                list(names)
            return save(ldir, pairs, names)
        return save_recruited

    def _align_banded(self, align):
        def align_banded(reads, rlens, hap_wins, score_vec, band=48,
                         max_del_run=32):
            out = align(reads, rlens, hap_wins, score_vec, band, max_del_run)
            if reads.shape[0]:
                ix = self._pick(reads.shape[0], JOBS_PER_LAUNCH, reads.device)
                self.jobs.append((self.call, reads[ix], rlens[ix],
                                  hap_wins[ix], score_vec.clone(), band,
                                  max_del_run,
                                  {k: v[ix] for k, v in out.items()}))
            return out
        return align_banded

    def _anneal_chains(self, anneal):
        def anneal_chains(probs, winpk, vcount, nt_ixs, ntc, start_temp,
                          wtab, assgn0, depth0, cache0, **kw):
            out = anneal(probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab,
                         assgn0, depth0, cache0, **kw)
            if winpk.shape[0]:
                c = self._pick(winpk.shape[0], CHAINS_PER_LAUNCH,
                               probs.device)
                g = torch.div(c, kw["attempts"], rounding_mode="floor")
                lik, assgn, _ = out
                self.chains.append(dict(
                    call=self.call, probs=probs[g], winpk=winpk[c],
                    wtab=wtab[c], lik=lik[c], assgn=assgn[c],
                    anneals=kw["anneal_steps"] > 0, dc=kw["dc"],
                    ac=kw["ac"]))
            return out
        return anneal_chains

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        for where, attr, make in (
                ("locityper_tpu_torch.commands.genotype", "_save_recruited",
                 self._save_recruited),
                ("locityper_tpu_torch.ops.align", "align_banded",
                 self._align_banded),
                ("locityper_tpu_torch.ops.solver_chains", "anneal_chains",
                 self._anneal_chains)):
            self._stack.enter_context(patch(where, attr, make))
        return self

    def __exit__(self, *exc):
        self._stack.close()


def read_calls(out_dir: Path, loci):
    """{locus: called genotype as sorted haplotype names, None if absent}."""
    calls = {}
    for lc in loci:
        path = out_dir / "loci" / lc.name / "res.json.gz"
        try:
            with gzip.open(path, "rt") as f:
                gt = json.load(f).get("genotype")
        except (OSError, ValueError):
            gt = None
        calls[lc.name] = None if gt is None else sorted(gt.split(","))
    return calls


def wrong_call_share(outs, loci, samples):
    """outs: [(output directory, sample index)]."""
    wrong = total = 0
    for out, s in outs:
        truth = samples[s].truth
        for name, got in read_calls(out, loci).items():
            want = sorted(loci[[lc.name for lc in loci].index(name)]
                          .hap_names[i] for i in truth[name])
            wrong += got != want
            total += 1
    return wrong / max(total, 1)


def recruit_diff(probe_recruited, expected):
    """probe_recruited: {call: {locus: names}}; expected: {call: {locus:
    set of names}} from the reference."""
    diff = 0
    for call, want in expected.items():
        got = probe_recruited.get(call, {})
        for locus, names in want.items():
            diff += len(set(got.get(locus, ())) ^ names)
    return diff


def _origins(sample: gen.Sample, flank, recruited_names):
    """Byte strings of both strands of every mate of the pairs (every
    single read) the reference recruited in a sample."""
    by_name = dict(zip(sample.names, zip(sample.mates1, sample.mates2)
                       if sample.mates2 is not None
                       else ((m,) for m in sample.mates1)))
    fn = {}
    out = set()
    for name in recruited_names:
        if name in by_name:
            mates = by_name[name]
        else:
            if not fn and flank is not None:
                fn = {n: i for i, n in enumerate(flank[0])}
            i = fn[name]
            mates = (flank[1][i], flank[2][i])
        for m in mates:
            out.add(m.astype(np.int8).tobytes())
            out.add(gen.revcomp(m).tobytes())
    return out


def haplotype_bytes(loci) -> bytes:
    """Every panel haplotype, one code a byte, each followed by an N, so
    that a window is a stretch of some haplotype exactly when its bytes
    occur here."""
    return b"".join(np.append(h.astype(np.int8), np.int8(4)).tobytes()
                    for lc in loci for h in lc.haplotypes)


def _blocks(group, row_bytes):
    """The probed launches of `group` in runs of at most ALIGN_BLOCK_BYTES
    of reads and windows at `row_bytes` a job (one launch at the least)."""
    block, size = [], 0
    for job in group:
        n = job[1].shape[0] * row_bytes
        if block and size + n > ALIGN_BLOCK_BYTES:
            yield block
            block, size = [], 0
        block.append(job)
        size += n
    if block:
        yield block


def align_groups(jobs):
    """Probed launches of one band, deletion cap and score vector, which
    the reference aligner takes together."""
    groups = {}
    for job in jobs:
        sv, band, mdr = job[4:7]
        groups.setdefault((band, mdr, sv.cpu().numpy().tobytes()),
                          []).append(job)
    return list(groups.values())


def reference_align(group, dtype=torch.float32):
    """The reference aligner's outputs for the launches of one group, one
    dict a launch.  Reads and windows are padded with N to the group's
    widest, which leaves every job's result as it was (the aligner reads a
    job's rows up to its length only), so launches of many widths take one
    pass of rows a block."""
    sv, band, mdr = group[0][4:7]
    L = max(j[1].shape[1] for j in group)
    W = max(j[3].shape[1] for j in group)

    def pad(x, width):
        return torch.nn.functional.pad(x, (0, width - x.shape[1]), value=4)

    out = []
    for block in _blocks(group, L + W):
        want = reference.align(torch.cat([pad(j[1], L) for j in block]),
                               torch.cat([j[2] for j in block]),
                               torch.cat([pad(j[3], W) for j in block]),
                               sv, band, mdr, dtype)
        parts = {k: v.split([j[1].shape[0] for j in block])
                 for k, v in want.items()}
        out += [{k: v[i] for k, v in parts.items()}
                for i in range(len(block))]
    return out


def align_diff(jobs, sample_of_call, origins_of_sample, haplotypes):
    """Jobs whose outputs differ from the reference aligner's, or whose
    read or window has no origin in the sample."""
    bad = 0
    for group in align_groups(jobs):
        for job, want in zip(group, reference_align(group)):
            call, reads, rlens, wins, *_, got = job
            same = torch.ones(reads.shape[0], dtype=torch.bool,
                              device=reads.device)
            for k, v in want.items():
                same &= got[k].to(v.dtype) == v
            same = same.cpu().numpy()
            origins = origins_of_sample[sample_of_call[call]]
            r_np, l_np = reads.cpu().numpy(), rlens.cpu().numpy()
            for j, w in enumerate(wins.cpu().numpy()):
                core = np.trim_zeros(np.where(w >= 4, 0, w.astype(int) + 1))
                bad += not (same[j]
                            and r_np[j, :l_np[j]].tobytes() in origins
                            and (core - 1).astype(np.int8).tobytes()
                            in haplotypes)
    return bad


def chain_numbers(chains):
    """(lik_gap, unpolished_share) of the sampled chains."""
    gap, unpolished, n = 0.0, 0, 0
    for ch in chains:
        state = (ch["probs"], ch["winpk"], ch["wtab"], ch["assgn"], ch["dc"],
                 ch["ac"])
        end = reference.chain_likelihood(*state)
        rel = ((ch["lik"].double() - end).abs() / end.abs().clamp(min=1.0))
        gap = max(gap, float(rel.max()))
        if ch["anneals"]:
            gain = reference.best_move_gain(*state)
            movable = torch.isfinite(gain)
            unpolished += int((gain[movable] > STEP_UP).sum())
            n += int(movable.sum())
    return gap, unpolished / n if n else 1.0


def expected_recruitment(calls, loci, genome, starts, samples, flank,
                         device, bits=32):
    """{call: {locus: set of names}} by the reference (with `bits` < 32,
    the control's) for every probed call's sample."""
    index = reference.RecruitIndex(loci, genome, starts, device, bits)
    # The flank pairs, shared by every sample, are decided once.
    shared = {} if flank is None else reference.recruit(index, [], [], [],
                                                        flank)
    by_sample = {}
    out = {}
    for c, s, _ in calls:
        if c is None:
            continue
        if s not in by_sample:
            smp = samples[s]
            own = reference.recruit_single(index, smp.names, smp.mates1) \
                if smp.mates2 is None else \
                reference.recruit(index, smp.names, smp.mates1, smp.mates2)
            by_sample[s] = {k: v | shared.get(k, set())
                            for k, v in own.items()}
        out[c] = by_sample[s]
    return out


def evaluate(recruited, jobs, chains, calls, loci, samples, flank, expected):
    """The numbers compared.  `recruited`, `jobs` and `chains` as a Probe
    keeps them; `calls`: [(call index, sample index, output directory)]
    of the window's calls, and the command line's with call index None
    (not probed); `expected` from `expected_recruitment`."""
    sample_of_call = {c: s for c, s, _ in calls}
    numbers = {"recruit_diff": recruit_diff(recruited, expected)}
    origins = {}
    for c, want in expected.items():
        s = sample_of_call[c]
        if s not in origins:
            origins[s] = _origins(samples[s], flank,
                                  set().union(*want.values()))
    numbers["align_diff"] = align_diff(jobs, sample_of_call, origins,
                                       haplotype_bytes(loci))
    numbers["lik_gap"], numbers["unpolished_share"] = chain_numbers(chains)
    numbers["wrong_call_share"] = wrong_call_share(
        [(out, s) for _, s, out in calls], loci, samples)
    return numbers


def missing_outputs(outs, loci):
    """Calls that left a locus without res.json.gz."""
    return sum(not all((out / "loci" / lc.name / "res.json.gz").exists()
                       for lc in loci) for out in outs)


def verdict(numbers, limits, failed_calls):
    """(correct, {name: {"value", "limit"}}) and the lines for stderr."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NAMES}
    ok = failed_calls == 0 and all(numbers[n] <= limits[n] for n in NAMES)
    for n in NAMES:
        print(f"check {n} {numbers[n]!r} limit {limits[n]!r}",
              file=sys.stderr)
    print(f"check failed_calls {failed_calls} limit 0", file=sys.stderr,
          flush=True)
    checks["failed_calls"] = {"value": failed_calls, "limit": 0}
    return ok, checks
