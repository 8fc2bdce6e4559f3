"""Readings that the limits of `limits/<cell>.json` are set from: the
program's numbers on many seeds, and on some of them the control's and the
planted faults' numbers, each seed's set-up done once in one process.

    python3 -m bench_port.control --workload <cell> --seeds <n> ... \\
        --controls <k> --calls <c>

For every seed: the cell's set-up, then `--calls` genotype calls under the
probes, and the numbers of `check.py` for them (the program's readings).
For the first `--controls` seeds also:

* the control: the reference put in the program's place in a lower
  precision: recruitment with 16-bit minimizer keys, the aligner in
  bfloat16, the annealer's likelihood summed in bfloat16;
* the faults, each planted in the program for one more call: the annealer
  returning its state unchanged; half of every recruitment batch left out;
  a call altered where `res.json.gz` is written.

One JSON line a seed.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from . import check, reference
from .run import Cell, Spec, cache_env
from .trace import patch


def unchanged_state(orig):
    """The annealer returns the state it was given, with that state's
    likelihood, and reports every step as proposed."""
    def anneal_chains(probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab,
                      assgn0, depth0, cache0, **kw):
        g = torch.arange(winpk.shape[0], device=probs.device) \
            // kw["attempts"]
        lik = reference.chain_likelihood(probs[g], winpk, wtab, assgn0,
                                         kw["dc"], kw["ac"]).float()
        return lik, assgn0.clone(), torch.full_like(assgn0[:, 0],
                                                    kw["n_steps"])
    return anneal_chains


def half_batch(orig):
    """Recruitment leaves out half of every batch of pairs, every second
    pair."""
    def _pairs_decide(cfg, both, keys_signed, packed):
        dec = orig(cfg, both, keys_signed, packed)
        dec[1::2] = 0
        return dec
    return _pairs_decide


def altered_call(orig):
    """Every locus's call names another haplotype in place of its first."""
    def to_json(self, hap_names):
        obj = orig(self, hap_names)
        if "genotype" in obj:
            first, *rest = obj["genotype"].split(",")
            other = next(h for h in hap_names if h != first)
            obj["genotype"] = ",".join([other, *rest])
        return obj
    return to_json


#: Fault -> ("module" or "module:Class", attribute, wrapper maker).
FAULTS = {
    "unchanged_state": ("locityper_tpu_torch.ops.solver_chains",
                        "anneal_chains", unchanged_state),
    "half_batch": ("locityper_tpu_torch.ops.recruit", "_pairs_decide",
                   half_batch),
    "altered_call": ("locityper_tpu_torch.solvers.solve:Genotyping",
                     "to_json", altered_call),
}


def fault(name):
    """Plants a fault of FAULTS in the program while in use."""
    return patch(*FAULTS[name])


def probed_calls(cell, probe, first, n, sample=None):
    """n genotype calls under the probe; [(call, sample, out)]."""
    out = []
    for i in range(first, first + n):
        s = i % len(cell.samples) if sample is None else sample
        probe.call = i
        d = cell.work / f"out_{i}"
        if cell.call(s, d) != 0:
            raise RuntimeError(f"genotype call {i} failed")
        out.append((i, s, d))
    return out


def numbers_of(cell, probe, calls, device, bits=32):
    expected = check.expected_recruitment(calls, cell.loci, cell.genome,
                                          cell.starts, cell.samples,
                                          cell.flank, device)
    recruited = probe.recruited
    if bits != 32:
        recruited = {c: {k: sorted(v) for k, v in r.items()}
                     for c, r in check.expected_recruitment(
                         calls, cell.loci, cell.genome, cell.starts,
                         cell.samples, cell.flank, device, bits).items()}
    return check.evaluate(recruited, probe.jobs, probe.chains, calls,
                          cell.loci, cell.samples, cell.flank, expected)


def control_numbers(cell, probe, calls, device):
    """The reference in the program's place, in lower precision."""
    jobs = []
    for call, reads, rlens, wins, sv, band, mdr, _ in probe.jobs:
        low = reference.align(reads, rlens, wins, sv, band, mdr,
                              torch.bfloat16)
        jobs.append((call, reads, rlens, wins, sv, band, mdr, low))
    chains = []
    for ch in probe.chains:
        low = dict(ch)
        low["lik"] = reference.chain_likelihood(
            ch["probs"], ch["winpk"], ch["wtab"], ch["assgn"], ch["dc"],
            ch["ac"], torch.bfloat16)
        chains.append(low)
    probe_low = check.Probe(0)
    probe_low.recruited, probe_low.jobs, probe_low.chains = \
        probe.recruited, jobs, chains
    return numbers_of(cell, probe_low, calls, device, bits=16)


def one_seed(spec, seed, calls, controls, env, device):
    work = Path(tempfile.mkdtemp(prefix="bench_port_control_"))
    on_card = device != "cpu"
    try:
        cell = Cell(spec, seed, work,
                    device_args=() if on_card else ("--device", "cpu"),
                    sync=torch.cuda.synchronize if on_card else None)
        cell.draw()
        cell.add()
        if cell.call(0, work / "out_warm") != 0:
            raise RuntimeError("warm-up genotype failed")
        dev = torch.device(device)
        probe = check.Probe(seed)
        with probe:
            done = probed_calls(cell, probe, 0, calls)
        line = {"seed": seed, "program": numbers_of(cell, probe, done, dev)}
        if controls:
            line["control"] = control_numbers(cell, probe, done, dev)
            for j, name in enumerate(FAULTS):
                fp = check.Probe(seed)
                with fault(name), fp:
                    fc = probed_calls(cell, fp, 1000 + j, 1, sample=0)
                line[name] = numbers_of(cell, fp, fc, dev)
        return line
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = Spec(args.workload)
    env = dict(os.environ)
    env.update(cache_env(spec.root))
    os.environ.update(cache_env(spec.root))
    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_port.control: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        line = one_seed(spec, seed, args.calls, i < args.controls, env,
                        args.device)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
