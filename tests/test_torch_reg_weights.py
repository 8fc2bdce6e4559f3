"""Region weights (`genotype --reg-weights`) in the port, against the JAX
package, on the CPU.

With weights, every stored alignment's probability is recomputed by
`model/locs.py:_reweight_aln_probs`: the host traceback replays its CIGAR
at the stored DP window, and each operation counts with the weight of its
reference position, renormalized by length over weight
(tests/test_weighted_prof.py, reference windows.rs:507-575).  Held here:

- `_reweight_aln_probs` of both packages on the same alignments (the world
  of tests/test_weighted_prof.py:132-186): uniform weights, an interval
  weighted 0.01 that the reads straddle, and whole haplotypes weighted 0.05
  (every alignment fully inside: renormalized back to uniform); then
  `build_all_alignments` with those weights, end to end;
- `genotype --reg-weights` through both command lines on
  tests/test_torch_genotype_cmd.py's world: equal calls, equal to the truth;
- a mapping that names a missing BED: rc 1 in both
  (tests/test_cli.py:392-414).

Floats are held within 1e-6 relative: both packages compute these sums in
float64 numpy on the host.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from locityper_tpu import cli as jcli
from locityper_tpu.model import locs as jlocs
from locityper_tpu.model.locs import MateAlnTable as JMateAlnTable
from locityper_tpu.model.windows import ExplicitWeights as JExplicitWeights
from locityper_tpu_torch import convert
from locityper_tpu_torch.bg.err_prof import EditDistCache, EditThresh
from locityper_tpu_torch.model import Params
from locityper_tpu_torch.model import locs as tlocs
from locityper_tpu_torch.model.windows import ExplicitWeights

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_genotype_cmd import (LOCI, SCHEME, read_json,  # noqa: E402
                                     torch_cli, world)
from test_torch_ploidy import assert_options_close  # noqa: E402
import test_weighted_prof  # noqa: E402

torch.set_num_threads(1)        # the suite runs several workers side by side

WEIGHTS = {
    "uniform": {},
    "interval": {"hA": [(1450, 1650, 0.01)], "hB": [(1450, 1650, 0.01)]},
    "whole": {"hA": [(0, 3000, 0.05)], "hB": [(0, 3000, 0.05)]},
}


@pytest.fixture(scope="module")
def reweight_world():
    """tests/test_weighted_prof.py's two-haplotype world, with the JAX
    package's unweighted alignments of its 25 pairs, and the port's copy of
    every input."""
    cset, kc, bg, params, cache, pairs, names = \
        test_weighted_prof.TestPipelineReweight()._world()
    base, _ = jlocs.build_all_alignments(pairs, names, cset, kc, bg, cache,
                                         params)
    t_bg = convert.from_reference(bg)
    t_params = Params(unmapped_penalty=params.unmapped_penalty)
    t_params.set_tweak_size(t_bg.depth.window_size)
    t_params.band = params.band
    t_cache = EditDistCache(t_bg.err_prof, EditThresh.default_for(
        t_bg.seq_info.technology))
    mates = [m for pair in pairs for m in pair]
    return dict(cset=cset, kc=kc, bg=bg, params=params, cache=cache,
                pairs=pairs, names=names, base=base, mates=mates,
                t_cset=convert.from_reference(cset),
                t_kc=convert.from_reference(kc), t_bg=t_bg,
                t_params=t_params, t_cache=t_cache)


def copy_table(tbl):
    return JMateAlnTable(*(np.array(getattr(tbl, f))
                           for f in JMateAlnTable._FIELDS))


def reweighted(w, kind, package):
    """One package's `_reweight_aln_probs` on a copy of the world's table
    of alignments."""
    band = w["params"].band
    if package == "jax":
        tbl = copy_table(w["base"].table)
        jlocs._reweight_aln_probs(
            tbl, w["mates"], w["cset"], w["bg"].err_prof,
            JExplicitWeights(WEIGHTS[kind]), w["bg"].err_prof.score_vec(),
            band)
    else:
        tbl = convert.from_reference(w["base"].table)
        tlocs._reweight_aln_probs(
            tbl, w["mates"], w["t_cset"], w["t_bg"].err_prof,
            ExplicitWeights(WEIGHTS[kind]), w["t_bg"].err_prof.score_vec(),
            band)
    return tbl


@pytest.mark.parametrize("kind", list(WEIGHTS))
def test_reweight_equal(reweight_world, kind):
    """Both packages' `_reweight_aln_probs` on copies of one table of
    alignments: probabilities within 1e-6 relative, nothing else moved."""
    w = reweight_world
    assert len(w["base"].table) > 25
    j_tbl, t_tbl = reweighted(w, kind, "jax"), reweighted(w, kind, "port")
    np.testing.assert_allclose(t_tbl.prob, j_tbl.prob, rtol=1e-6, atol=0)
    for f in JMateAlnTable._FIELDS:
        if f != "prob":
            np.testing.assert_array_equal(getattr(t_tbl, f),
                                          getattr(j_tbl, f))
    # Against uniform weights: the straddling alignments change and the
    # others keep their probability; a weight the alignment lies wholly
    # inside is renormalized away (windows.rs:566-571).
    uni = reweighted(w, "uniform", "port").prob
    moved = ~np.isclose(t_tbl.prob, uni, rtol=1e-9, atol=0)
    if kind == "interval":
        assert 0 < moved.sum() < len(uni)
    else:
        assert not moved.any()


@pytest.mark.parametrize("kind", ["uniform", "interval"])
def test_build_all_alignments_with_weights_equal(reweight_world, kind):
    """`build_all_alignments(..., explicit_weights=)` end to end: the same
    candidates and their probabilities within 1e-6 relative."""
    w = reweight_world
    want, j_stats = jlocs.build_all_alignments(
        w["pairs"], w["names"], w["cset"], w["kc"], w["bg"], w["cache"],
        w["params"], explicit_weights=JExplicitWeights(WEIGHTS[kind]))
    got, stats = tlocs.build_all_alignments(
        w["pairs"], w["names"], w["t_cset"], w["t_kc"], w["t_bg"],
        w["t_cache"], w["t_params"],
        explicit_weights=ExplicitWeights(WEIGHTS[kind]), device="cpu")
    assert stats == j_stats
    np.testing.assert_array_equal(got.c_read, want.c_read)
    np.testing.assert_array_equal(got.c_hap, want.c_hap)
    np.testing.assert_allclose(got.c_prob, want.c_prob, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.table.prob, want.table.prob, rtol=1e-6,
                               atol=0)


def write_weights(world, root):
    """A weights file for GENE1: every haplotype weighted 0.1 over the
    middle kilobase, which the reads there straddle; the mapping names it
    by a path relative to itself."""
    locus = world.loci[0]
    bed = root / "gene1_weights.bed"
    bed.write_text("".join(f"{name}\t1500\t2500\t0.1\n"
                           for name in locus.hap_names))
    mapping = root / "weights.tsv"
    mapping.write_text(f"GENE1\t{bed.name}\n")
    return mapping


def test_cli_reg_weights_equal(world, tmp_path):
    """`genotype --reg-weights` through both command lines: both exit 0,
    and every call equals the truth and the other package's, likelihoods
    within the attempts' spread."""
    mapping = write_weights(world, tmp_path)
    args = [*world.base, *SCHEME, "--reg-weights", str(mapping),
            "--seed", "5"]
    j_out, t_out = tmp_path / "j_out", tmp_path / "t_out"
    assert jcli.main(["genotype", *args, "-o", str(j_out)]) == 0
    assert torch_cli("genotype", *args, "-o", t_out) == 0
    for name in LOCI:
        j_res = read_json(j_out / "loci" / name / "res.json.gz")
        res = read_json(t_out / "loci" / name / "res.json.gz")
        assert sorted(res["genotype"].split(",")) == world.truth[name], res
        assert res["genotype"] == j_res["genotype"]
        assert res["total_reads"] == j_res["total_reads"]
        assert_options_close(res, j_res)


def test_cli_reg_weights_missing_bed(world, tmp_path):
    mapping = tmp_path / "weights.tsv"
    mapping.write_text("GENE1\tnope.bed\n")
    args = [*world.base, "--reg-weights", str(mapping)]
    assert jcli.main(["genotype", *args, "-o", str(tmp_path / "j")]) == 1
    assert torch_cli("genotype", *args, "-o", tmp_path / "t") == 1
