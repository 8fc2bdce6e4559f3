"""The generator: the same seed gives the same inputs, and every seed the
same amount of work."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench_port import gen

ROOT = Path(gen.__file__).resolve().parent


def small(cfg_name, n_loci, haps=None):
    cfg = json.loads((ROOT / "configs" / f"{cfg_name}.json").read_text())
    cfg["panel"]["n_loci"] = n_loci
    if haps:
        cfg["panel"]["haps_per_clade"] = haps
    return cfg


TRAFFIC = json.loads((ROOT / "traffic" / "locus_reads.json").read_text())


@pytest.mark.parametrize("cfg", [small("hla_abc_sr", 3),
                                 small("hla_abc_sr", 2, haps=3)])
def test_same_seed_same_inputs(cfg):
    seed = 2**40 + 11           # seeds may exceed 32 bits
    a = gen.build_panel(cfg, seed)
    b = gen.build_panel(cfg, seed)
    assert np.array_equal(a[1], b[1]) and a[3] == b[3]
    sa = gen.draw_sample(a[0], cfg, TRAFFIC, seed, 1)
    sb = gen.draw_sample(b[0], cfg, TRAFFIC, seed, 1)
    assert sa.truth == sb.truth and sa.names == sb.names
    assert all(np.array_equal(x, y) for x, y in zip(sa.mates1, sb.mates1))
    fa = gen.flank_pairs(a[2], cfg, TRAFFIC, seed)
    fb = gen.flank_pairs(b[2], cfg, TRAFFIC, seed)
    assert np.array_equal(fa[0], fb[0]) and np.array_equal(fa[1], fb[1])
    c = gen.build_panel(cfg, seed + 1)
    assert not np.array_equal(a[1][:1000], c[1][:1000])


def test_every_seed_the_same_work():
    cfg = small("hla_abc_sr", 2, haps=2)
    counts = set()
    for seed in (1, 2**33, 7):
        loci, genome, flanks, _ = gen.build_panel(cfg, seed)
        f1, _ = gen.flank_pairs(flanks, cfg, TRAFFIC, seed)
        counts.add((len(loci), sum(f.size for f in flanks), f1.shape))
    assert len(counts) == 1


def test_truth_draws_two_clades_on_a_structured_panel():
    cfg = small("hla_abc_sr", 1, haps=3)
    loci, *_ = gen.build_panel(cfg, 5)
    lc = loci[0]
    for i in range(20):
        a, b = gen.draw_truth(np.random.default_rng(i), lc)
        assert lc.clade_of[a] != lc.clade_of[b]


def test_error_model_rates():
    rng = np.random.default_rng(0)
    bases = rng.integers(0, 4, (4000, 150)).astype(np.int8)
    out = gen.apply_errors(rng, bases, 0.01, 0.0, 0.0)
    assert all(o.size == 150 for o in out)
    assert np.mean(np.stack(out) != bases) == pytest.approx(0.01, rel=0.1)
    out = gen.apply_errors(rng, bases, 0.0, 0.005, 0.005)
    lens = np.array([o.size for o in out])
    # Insertions add a base, deletions take one: the mean length stays.
    assert abs(lens.mean() - 150) < 0.2
    assert (lens != 150).mean() > 0.5


def test_fastq_records(tmp_path):
    reads = np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.int8)
    text = gen.fastq_array_bytes(reads, "bg").decode()
    assert text == "@bg00000000\nACGT\n+\nIIII\n@bg00000001\nTGCA\n+\nIIII\n"
    assert gen.fastq_bytes(["x"], [np.array([0, 4], np.int8)]) \
        == b"@x\nAN\n+\nII\n"
