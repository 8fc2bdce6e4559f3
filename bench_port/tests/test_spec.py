"""BENCHMARK.json against the benchmark's rules, and every file it names
found by name; a configuration added as files loads without an edit."""
import json
import re
import shutil
from pathlib import Path

import pytest

from bench_port import run

ROOT = Path(run.__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["bench_port"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_metrics_follow_the_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"setup_s", "sample_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] == "sample_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    spec = run.Spec(cell)
    assert spec.cell["chips"] == 1
    assert spec.config["name"] == spec.cell["config"]
    assert spec.traffic["name"] == spec.cell["traffic"]
    assert set(spec.limits) == {"recruit_diff", "align_diff", "lik_gap",
                                "unpolished_share", "wrong_call_share"}
    for m in spec.metrics("per_layer"):
        assert callable(run.load_reader(spec, m["name"]))
    for key in next(c for c in BENCH["configs"]
                    if c["name"] == spec.cell["config"])["reduced"]:
        assert key in spec.config


def test_an_added_configuration_needs_no_edit(tmp_path):
    """A later change adds a configuration, a traffic mix, a limit file and
    a per-layer metric as new files and entries; nothing there is edited."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench_port/configs/hla_abc_sr.json")
                     .read_text())
    cfg["name"] = "hla_a_sr"
    cfg["panel"]["n_loci"] = 1
    (tmp_path / "bench_port/configs/hla_a_sr.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((ROOT / "bench_port/traffic/locus_reads.json")
                         .read_text())
    traffic["name"] = "deep"
    traffic["locus_depth"] = 30.0
    (tmp_path / "bench_port/traffic/deep.json").write_text(
        json.dumps(traffic))
    (tmp_path / "bench_port/limits/hla_a_sr.deep.json").write_text(
        (ROOT / "bench_port/limits/hla_abc_sr.locus_reads.json").read_text())
    (tmp_path / "bench_port/metrics/calls_n.py").write_text(
        "def read(trace):\n    return float(len(trace.calls)) or None\n")
    bench["configs"].append(dict(bench["configs"][0], name="hla_a_sr",
                                 file="bench_port/configs/hla_a_sr.json"))
    bench["workloads"].append({"name": "hla_a_sr.deep",
                               "config": "hla_a_sr", "traffic": "deep",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_n", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "sample_s",
                               "workloads": ["hla_a_sr.deep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.Spec("hla_a_sr.deep", tmp_path / "BENCHMARK.json")
    assert spec.config["panel"]["n_loci"] == 1
    assert spec.traffic["locus_depth"] == 30.0
    names = [m["name"] for m in spec.metrics("per_layer")]
    assert "calls_n" in names
    from bench_port.trace import Trace
    assert run.load_reader(spec, "calls_n")(Trace(calls=[(0, 1)])) == 1.0
    other = run.Spec(CELLS[0], tmp_path / "BENCHMARK.json")
    assert "calls_n" not in [m["name"] for m in other.metrics("per_layer")]
