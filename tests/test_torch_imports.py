"""The port stands alone: no `jax`, nothing of the JAX package.

A subprocess poisons `sys.modules["jax"]` and `sys.modules["locityper_tpu"]`,
imports every module of `locityper_tpu_torch` and genotypes a tiny locus on
`device="cpu"`, from two FASTQ files through the device recruiter, under the
sequential engine (`e=seq`), writing the called genotype's SAM file; another
runs `python -m locityper_tpu_torch.cli --help` poisoned the same way; the
sources of the package, of `chip_smoke.py` and of `time_minimizer_front.py`
are also searched for such imports.  Every `.py` file of the JAX package has
its counterpart in the port: a file of the same relative path, or the CUDA
sources (and wrapper) that do a Pallas file's work.
"""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import locityper_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "locityper_tpu_torch"

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["locityper_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)        # the suite runs several workers side by side
import locityper_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    locityper_tpu_torch.__path__, "locityper_tpu_torch.")
    if not m.name.endswith(".libkernels")]      # the ctypes host library
for n in names:
    importlib.import_module(n)
for n in ("cli", "commands.genotype", "commands.recruit", "commands.add",
          "commands.align", "commands.boundary", "commands.index",
          "commands.paf_vcf", "commands.preproc", "commands.prune",
          "model.sam", "ops.recruit", "seq.bam", "seq.bai", "seq.cram",
          "seq.crai", "seq.dist", "seq.panvcf"):
    assert "locityper_tpu_torch." + n in names, n
assert not any(k == "jax" or k.startswith("jax.") for k, v in
               sys.modules.items() if v is not None)

from locityper_tpu_torch import sim
from locityper_tpu_torch.bg import BgDistr, SequencingInfo, Technology
from locityper_tpu_torch.bg.depth import ReadDepth
from locityper_tpu_torch.bg.err_prof import ErrorProfile
from locityper_tpu_torch.bg.insertsz import InsertDistr
from locityper_tpu_torch.mathx.distr import NBinom
from locityper_tpu_torch.model.locs import build_all_alignments_panel
from locityper_tpu_torch.bg.err_prof import EditDistCache, EditThresh
from locityper_tpu_torch.model import Params
from locityper_tpu_torch.commands.genotype import recruit_reads_fast
from locityper_tpu_torch.pipeline import (LocusData, genotype_panel,
                                          recruit_reads)
from locityper_tpu_torch.seq import fastx
from locityper_tpu_torch.seq.contigs import ContigSet
from locityper_tpu_torch.seq.counts import GenomeKmerCounter, off_target_counts
from locityper_tpu_torch.seq.recruit import RecruitParams
from locityper_tpu_torch.solvers.solve import Scheme

rng = np.random.default_rng(5)
locus = sim.simulate_locus(rng, "T0", length=1500, n_haps=3, divergence=0.02)
genome = np.concatenate([sim.random_genome(rng, 8000), locus.haplotypes[0],
                         sim.random_genome(rng, 8000)])
counter = GenomeKmerCounter(25)
counter.add_seq(genome)
counter.finalize()
data = {"T0": LocusData(
    ContigSet("T0", locus.hap_names, locus.haplotypes),
    off_target_counts(counter, locus.haplotypes, locus.haplotypes[0]))}
truth = (0, 2)
rd = sim.simulate_paired_reads(
    rng, [locus.haplotypes[h] for h in truth], depth=12.0,
    errors=sim.ErrorModel(0.002, 0.0002, 0.0002), prefix="T0")
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/r1.fq", "w") as f1, open(tmp + "/r2.fq", "w") as f2:
        for n, a, b in zip(rd.names, rd.reads1, rd.reads2):
            fastx.write_fastq(f1, fastx.Read(n, a))
            fastx.write_fastq(f2, fastx.Read(n, b))
    rec, _ = recruit_reads_fast(data, tmp + "/r1.fq", tmp + "/r2.fq",
                                RecruitParams(match_frac=0.5), batch=256,
                                device="cpu")
host = recruit_reads(data, zip(rd.names, rd.reads1, rd.reads2),
                     RecruitParams(match_frac=0.5), pad=9)
assert rec["T0"][1] == host["T0"][1] and len(rec["T0"][1]) > 50
m = 12.0 * 100 / 300 / 2.0
bg = BgDistr(
    SequencingInfo(150.0, Technology.ILLUMINA),
    InsertDistr.from_nbinom(NBinom.estimate(400.0, 4000.0)),
    ErrorProfile.estimate(997600, 2000, 200, 200,
                          [(0, 150, 100.0), (1, 150, 50.0)]),
    ReadDepth(2, 100, 300, [NBinom.estimate(m, m * 1.6)] * 101))
tech = bg.seq_info.technology
params = Params(unmapped_penalty=tech.default_unmapped_penalty())
params.set_tweak_size(bg.depth.window_size)
params.band = 48
cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
built = build_all_alignments_panel(
    [(rec["T0"][0], rec["T0"][1], data["T0"].contig_set,
      data["T0"].kmer_counts)], bg, cache, params, device="cpu")
params.out_sams = 1
with tempfile.TemporaryDirectory() as sam_dir:
    out = genotype_panel(
        [dict(locus=data["T0"], read_pairs=rec["T0"][0], names=rec["T0"][1],
              tag="T0", prebuilt=built[0], sam_dir=sam_dir)], bg,
        params=params,
        scheme=Scheme.parse(["greedy:i=5k,a=1,p=30,e=seq",
                             "anneal:i=3,a=3,n=300,p=150,e=seq"]),
        seed=2, device="cpu")
    import gzip, os
    with gzip.open(os.path.join(sam_dir, "00.sam.gz"), "rt") as f:
        assert sum(not l.startswith("@") for l in f) > 50
call = tuple(sorted(int(h) for h in out[0][0].genotypes[0]))
assert call == truth, (call, truth)
print("OK", len(names), call)
"""


_CLI_CHILD = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["locityper_tpu"] = None
sys.argv = ["locityper_tpu_torch.cli"] + sys.argv[1:]
runpy.run_module("locityper_tpu_torch.cli", run_name="__main__")
"""


@pytest.mark.parametrize("argv,needle", [
    (["--help"], "--device {cuda,cpu}"),
    (["genotype", "--help"], "--stop-after"),
    (["recruit", "--help"], "--preset"),
])
def test_cli_help_runs_with_jax_and_reference_package_poisoned(argv, needle):
    proc = subprocess.run([sys.executable, "-c", _CLI_CHILD, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "locityper-tpu-torch" in proc.stdout and needle in proc.stdout
    for cmd in ("add", "preproc", "genotype", "recruit", "align", "prune",
                "paf-vcf", "index"):
        assert argv != ["--help"] or cmd in proc.stdout


def test_port_runs_with_jax_and_reference_package_poisoned():
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("OK ")


_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|locityper_tpu)(?:[.\s]|$)", re.M)


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "time_minimizer_front.py"]
    assert len(files) >= 55 and all(f.exists() for f in files)
    return files


def test_no_source_imports_jax_or_the_reference_package():
    bad = [(str(f.relative_to(ROOT)), m.group(0).strip())
           for f in _sources()
           for m in _IMPORT_RE.finditer(f.read_text())]
    assert not bad, bad
    assert _IMPORT_RE.search("from locityper_tpu.ops import align")
    assert _IMPORT_RE.search("    import jax")
    assert not _IMPORT_RE.search("from locityper_tpu_torch.ops import align")


def test_every_module_is_importable_here():
    """No module needs nvcc, triton or a card at import time."""
    mods = [m.name for m in pkgutil.walk_packages(
        locityper_tpu_torch.__path__, "locityper_tpu_torch.")
        if not m.name.endswith(".libkernels")]  # the ctypes host library
    assert "locityper_tpu_torch.ops.solver_chains" in mods
    assert "locityper_tpu_torch.convert" in mods
    assert "locityper_tpu_torch.cli" in mods
    assert "locityper_tpu_torch.commands.genotype" in mods
    assert "locityper_tpu_torch.ops.recruit" in mods
    for name in mods:
        __import__(name)


def test_kernel_sources_are_in_the_package():
    from locityper_tpu_torch import _kernels
    for name, (src, fn, argtypes) in _kernels.KERNELS.items():
        text = (_kernels.CSRC / src).read_text()
        assert f'extern "C" int {fn}(' in text, name
        assert "__global__" in text
    assert set(_kernels.LAUNCHES) == set(_kernels.KERNELS)
    assert {src for src, _fn, _at in _kernels.KERNELS.values()} == {
        "align_banded.cu", "anneal_chains.cu", "minimizer_front.cu"}
    assert {"minimizer_front_compact", "minimizer_front_full"} \
        <= set(_kernels.KERNELS)


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    from locityper_tpu_torch._kernels import resolve_device
    from locityper_tpu_torch.pipeline import genotype_panel
    from locityper_tpu_torch.solvers.solve import Scheme, solve_panel
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        genotype_panel([], None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_panel([], None, None, Scheme.default(), 1)
    from locityper_tpu_torch.pipeline import (recruit_reads_fast,
                                              recruit_records)
    from locityper_tpu_torch.seq.recruit import RecruitParams
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recruit_records({}, iter(()), RecruitParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recruit_reads_fast({}, "a.fq", "b.fq", RecruitParams())


#: JAX-package files whose work the port does in files of other names.
COUNTERPARTS = {
    "ops/align_pallas.py": ("ops/csrc/align_banded.cu",),
    "ops/solver_pallas.py": ("ops/csrc/anneal_chains.cu",
                             "ops/solver_chains.py"),
}


@pytest.mark.parametrize("rel", sorted(
    p.relative_to(ROOT / "locityper_tpu").as_posix()
    for p in (ROOT / "locityper_tpu").rglob("*.py")))
def test_every_module_of_the_jax_package_has_its_counterpart(rel):
    """Every `.py` file of the JAX package has a file of the same relative
    path in the port, or the counterparts named in COUNTERPARTS."""
    for other in COUNTERPARTS.get(rel, (rel,)):
        assert (PKG / other).is_file(), f"{rel}: no {other} in the port"
