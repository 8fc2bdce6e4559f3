"""One run of one cell of the port's benchmark.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout holding `BENCHMARK.json`, on a machine with an
NVIDIA GPU.  Set-up draws the cell's panel and samples from the seed,
builds the database with the port's `add`, builds (or finds) the kernels,
times one fresh `python -m locityper_tpu_torch.cli genotype` process on one
sample where the cell reports `cli_sample_s`, and warms up with one
`genotype` call in this process.  The window
then calls `locityper_tpu_torch.cli.main(["genotype", ...])` on one sample
after another until `--seconds` have passed.  Afterwards the timed path's
outputs are held against the plain reference (`check.py`), and the last
line of standard output is one JSON object.  With `--trace 1` the window
runs under spans and `torch.profiler`, and the line holds the per-layer
metrics instead of the end-to-end ones.

Without a CUDA device the run exits 2 and prints no result: nothing falls
back to the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that may not be loaded by the end of a run: JAX and
#: the JAX package (compared whole: the port's name begins with the latter).
FORBIDDEN = ("jax", "jaxlib", "flax", "locityper_tpu")


class Spec:
    """The cell, its configuration and its traffic mix, found by the names
    that BENCHMARK.json gives them."""

    def __init__(self, workload: str, bench_path=None):
        bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
        self.bench = json.loads(bench_path.read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                             f"has {sorted(cells)}")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.root = bench_path.parent
        self.config = json.loads(
            (self.root / configs[self.cell["config"]]["file"]).read_text())
        self.traffic = json.loads(
            self.data("traffic", self.cell["traffic"]).read_text())
        self.limits = json.loads(self.data("limits", workload).read_text())

    def data(self, kind, name, suffix=".json"):
        """bench_port/<kind>/<name><suffix> beside BENCHMARK.json."""
        return self.root / HERE.name / kind / f"{name}{suffix}"

    def metrics(self, kind):
        """The cell's metrics of `kind` (end_to_end or per_layer)."""
        return [m for m in self.bench[kind]
                if self.cell["name"] in m.get("workloads",
                                              [self.cell["name"]])]


def load_reader(spec: Spec, name):
    """metrics/<name>.py's `read(trace)`."""
    path = spec.data("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cache_env(root: Path):
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / "build" / "bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "PYTORCH_KERNEL_CACHE_PATH": str(cache / "torch_kernels")}


def background_model(traffic):
    """The saved background distributions in the port's JSON layout; a
    model of single reads has no insert distribution (`{}`)."""
    m = dict(traffic["background_model"])
    m.setdefault("insert_distr", {})
    d = m.pop("bg_depth")
    m["bg_depth"] = {"ploidy": d["ploidy"], "window": d["window"],
                     "neighb": d["neighb"], "n": [d["n"]] * d["gc_bins"],
                     "p": [d["p"]] * d["gc_bins"]}
    return m


class Cell:
    """The set-up and the window of one run, in the directory `work`."""

    def __init__(self, spec: Spec, seed: int, work: Path,
                 device_args=(), sync=None):
        self.seed, self.work = seed, work
        self.device_args = list(device_args)
        self.sync = sync or (lambda: None)
        self.cfg, self.traffic = spec.config, spec.traffic

    # -- set-up --------------------------------------------------------------

    def draw(self):
        """The panel, the genome, the samples and their FASTQ files: two a
        sample of pairs, the shared flank pairs appended to each; one a
        sample of single reads, its off-target reads its own."""
        from . import gen
        cfg, tr, work = self.cfg, self.traffic, self.work
        self.loci, self.genome, flanks, self.starts = gen.build_panel(
            cfg, self.seed)
        if gen.single_reads(cfg):
            self.samples = [gen.draw_single_sample(self.loci, flanks, cfg, tr,
                                                   self.seed, i)
                            for i in range(tr["samples"])]
            self.flank = None
            self.fastq = [gen.write_sample_single(work, i, s)
                          for i, s in enumerate(self.samples)]
        else:
            self._draw_pairs(flanks)
        self.ref, self.bed, self.haps = gen.write_add_inputs(
            work, self.loci, self.genome, self.starts)
        self.db, self.prep = work / "db", work / "sample"
        gen.write_background_model(self.prep, background_model(tr))

    def _draw_pairs(self, flanks):
        from . import gen
        cfg, tr, work = self.cfg, self.traffic, self.work
        self.samples = [gen.draw_sample(self.loci, cfg, tr, self.seed, i)
                        for i in range(tr["samples"])]
        f1, f2 = gen.flank_pairs(flanks, cfg, tr, self.seed)
        self.flank = (gen.flank_names(f1.shape[0]), f1, f2)
        gz = [work / "flank_1.fq.gz", work / "flank_2.fq.gz"]
        gen.write_gzip_pair(gz, [gen.fastq_array_bytes(f1, "bg"),
                                 gen.fastq_array_bytes(f2, "bg")])
        self.fastq = [gen.write_sample_fastq(work, i, s, gz)
                      for i, s in enumerate(self.samples)]
        for p in gz:
            p.unlink()

    def genotype_args(self, sample, out):
        """`genotype` of one sample; a configuration's `genotype_options`
        (genotype's own options, such as a scheme) come last."""
        return ["genotype", "-i", *map(str, self.fastq[sample]), "-d",
                str(self.db), "-p", str(self.prep), "-o", str(out),
                *self.cfg.get("genotype_options", ())]

    def add(self):
        from locityper_tpu_torch import cli
        rc = cli.main([*self.device_args, "add", "-d", str(self.db), "-r",
                       str(self.ref), "-l", str(self.bed), "-s", self.haps])
        if rc != 0:
            raise RuntimeError(f"add returned {rc}")

    def command_line(self, env):
        """One fresh command-line process on the last sample: seconds,
        output directory."""
        s = len(self.samples) - 1
        out = self.work / "out_cli"
        log = self.work / "cli.log"
        t0 = time.perf_counter()
        with open(log, "wb") as f:
            rc = subprocess.run(
                [sys.executable, "-m", "locityper_tpu_torch.cli",
                 *self.device_args, *self.genotype_args(s, out)],
                stdout=f, stderr=subprocess.STDOUT, env=env,
                cwd=str(ROOT)).returncode
        secs = time.perf_counter() - t0
        if rc != 0:
            tail = log.read_bytes()[-4000:].decode(errors="replace")
            raise RuntimeError(f"command line genotype returned {rc}:\n{tail}")
        return secs, out

    def call(self, sample, out):
        from locityper_tpu_torch import cli
        rc = cli.main([*self.device_args, *self.genotype_args(sample, out)])
        self.sync()
        return rc

    # -- window --------------------------------------------------------------

    def window(self, seconds, probe):
        """Calls on one sample after another until `seconds` have passed;
        returns [(call, sample, out, t0, t1, rc)] and the window's start.
        Each call's wall and CPU seconds and the host's load go to standard
        error, to tell a slower host from more work."""
        calls, cpu = [], []
        t_w0 = time.perf_counter()
        i = 0
        while True:
            s = i % len(self.samples)
            out = self.work / f"out_{i}"
            probe.call = i
            t0, c0 = time.perf_counter(), time.process_time()
            rc = self.call(s, out)
            t1 = time.perf_counter()
            calls.append((i, s, out, t0, t1, rc))
            cpu.append(time.process_time() - c0)
            i += 1
            if t1 - t_w0 >= seconds:
                pairs = [(round(c[4] - c[3], 3), round(u, 3))
                         for c, u in zip(calls, cpu)]
                print(f"bench_port: calls (wall s, cpu s) {pairs}; "
                      f"load {os.getloadavg()}", file=sys.stderr)
                return calls, t_w0


def sample_seconds(t_w0, calls):
    """Seconds a sample: from the window's start to the end of the last
    completed call, over the calls completed."""
    return (calls[-1][4] - t_w0) / len(calls)


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run(spec: Spec, seed: int, seconds: float, traced: bool, env,
        device="cuda"):
    """Set-up, window and checks; returns the result's object.  `device`
    "cpu" runs the plain versions of the kernels (the harness's own tests),
    untraced."""
    import torch

    from . import check, trace as T
    from locityper_tpu_torch import _kernels, native
    native.available()              # the host library, built on first use

    on_card = device != "cpu"
    work = Path(tempfile.mkdtemp(prefix="bench_port_"))
    try:
        cell = Cell(spec, seed, work,
                    device_args=() if on_card else ("--device", "cpu"),
                    sync=torch.cuda.synchronize if on_card else None)
        cell.draw()
        cell.add()
        if on_card:
            _kernels.load()         # built here on a checkout's first run
            print(f"bench_port: {power_limit()}; CUDA initialised before "
                  f"the command line: {torch.cuda.is_initialized()}",
                  file=sys.stderr)
        # The fresh command-line process runs only for a cell that reports
        # it; its outputs are then checked with the window's.
        cli = [cell.command_line(env)] if "cli_sample_s" in [
            m["name"] for m in spec.metrics("end_to_end")] else []
        if cell.call(0, work / "out_warm") != 0:
            raise RuntimeError("warm-up genotype failed")
        setup_s = time.perf_counter() - T_START

        trace = T.Trace()
        probe = check.Probe(seed)
        launches0 = dict(_kernels.LAUNCHES)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with probe:
            if traced:
                timeline = T.DeviceTimeline(trace, work / "trace.json")
                with T.tracer(trace), timeline:
                    calls, t_w0 = cell.window(seconds, probe)
                trace.window = (timeline.marker_host, timeline.end_host)
            else:
                calls, t_w0 = cell.window(seconds, probe)
        dev_info = {"platform": "gpu" if on_card else "cpu",
                    "kind": torch.cuda.get_device_name(0) if on_card
                    else "cpu", "count": int(spec.cell["chips"])}
        dev_info["memory_peak_bytes"] = int(max(
            torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count()))) if on_card else 0

        print("bench_port: kernel launches in the window "
              f"(_kernels.LAUNCHES) "
              f"{ {k: v - launches0[k] for k, v in _kernels.LAUNCHES.items()} }",
              file=sys.stderr)
        metrics, breakdown = {}, None
        if traced:
            trace.calls = [(c[3], c[4]) for c in calls]
            if not timeline.read():
                print("bench_port: no marker kernel in the trace; device "
                      "times placed from the window's start",
                      file=sys.stderr)
            dev_info["busy_s"] = trace.busy_s
            dev_info["window_s"] = trace.window_s
            for m in spec.metrics("per_layer"):
                value = load_reader(spec, m["name"])(trace)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = T.breakdown(trace)
            print("bench_port: launches the wrappers recorded "
                  f"{ {k: len(v) for k, v in trace.launches.items()} }",
                  file=sys.stderr)
            print(f"bench_port: traced window {len(calls)} calls, "
                  f"{sample_seconds(t_w0, calls)!r} s a sample",
                  file=sys.stderr)
        else:
            values = {"setup_s": setup_s,
                      "sample_s": sample_seconds(t_w0, calls)}
            values.update({"cli_sample_s": secs for secs, _ in cli})
            for m in spec.metrics("end_to_end"):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

        # The reference runs once the window's state is freed.
        del trace
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        window_calls = [(c[0], c[1], c[2]) for c in calls]
        expected = check.expected_recruitment(
            window_calls, cell.loci, cell.genome, cell.starts, cell.samples,
            cell.flank, torch.device(device))
        numbers = check.evaluate(
            probe.recruited, probe.jobs, probe.chains,
            window_calls + [(None, len(cell.samples) - 1, out)
                            for _, out in cli],
            cell.loci, cell.samples, cell.flank, expected)
        n_failed = sum(rc != 0 for *_, rc in calls) + \
            check.missing_outputs([c[2] for c in calls], cell.loci)
        print(f"bench_port: set-up {setup_s:.2f} s, window "
              f"{calls[-1][4] - t_w0:.2f} s ({len(calls)} calls), "
              f"reference {time.perf_counter() - t_ref:.2f} s",
              file=sys.stderr)
        correct, checks = check.verdict(numbers, spec.limits, n_failed)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": n_failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = Spec(args.workload)
    env = dict(os.environ)
    env.update(cache_env(ROOT))
    os.environ.update(cache_env(ROOT))

    import torch
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found.  No result.", file=sys.stderr)
        return 2
    result = run(spec, args.seed, args.seconds, bool(args.trace), env)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: modules loaded that the benchmark may not load: "
              f"{bad}.  No result.", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
