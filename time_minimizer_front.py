#!/usr/bin/env python3
"""Times builds of `minimizer_front.cu` against each other on one GPU.

    python3 time_minimizer_front.py [SOURCE.cu ...]

Each SOURCE (default: the one in `locityper_tpu_torch/ops/csrc/`) is built
with the port's own flags (`_kernels.ARCH_FLAGS`, `COMMON_FLAGS`) into
`build/variants/` and loaded with ctypes.  Every build is first held against
the plain PyTorch version bit for bit, on the two main-path shapes of
`chip_smoke.py` and on the edge shapes below; then the builds are timed in
turns (A B ... B A, three rounds, `chip_smoke.time_ms` each: CUDA events,
median of 5 warm launches) on the two main-path shapes.  A build that fails
to compile or differs is reported and left out of the timing.  Prints the
card's name and power limit first.
"""
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import front_bound_ms, make_reads, time_ms
from locityper_tpu_torch import _kernels
from locityper_tpu_torch.ops import recruit as R

#: (label, B, L, k, w, S); the first two are the main path's launches
SHAPES = [("compact", 65536, 192, 15, 10, R._front_S(178, 10)),
          ("full", 128, 16384, 15, 10, None),
          ("edge", 999, 152, 15, 10, 8), ("edge", 333, 1000, 15, 10, 40),
          ("edge", 77, 3001, 13, 63, None), ("edge", 9, 2000, 15, 1024, 30),
          ("edge", 9, 2000, 15, 1024, None), ("edge", 1, 15, 15, 10, 4),
          ("edge", 37, 47, 7, 1, 160)]


def build(src: Path):
    out = _kernels.build_dir().parent / "variants"
    out.mkdir(parents=True, exist_ok=True)
    flags = (*_kernels.ARCH_FLAGS, *_kernels.COMMON_FLAGS)
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    so = out / f"{src.stem}_{h}.so"
    run = subprocess.run([_kernels._find_nvcc(), *flags, "-Xptxas", "-v",
                          "-o", str(so), str(src)], capture_output=True,
                         text=True, timeout=600)
    if run.returncode:
        raise RuntimeError(run.stdout + run.stderr)
    for line in run.stderr.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(so))
    for name in ("minimizer_front_compact", "minimizer_front_full"):
        _src, fn, argtypes = _kernels.KERNELS[name]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def front(lib, reads, k, w, S):
    """The wrapper's launch, through the library `lib`."""
    B, L = reads.shape
    cols = L - k + 1 if S is None else S
    hs = torch.empty((B, cols), dtype=torch.int32, device="cuda")
    is_fw = torch.empty((B, cols), dtype=torch.bool, device="cuda")
    mask = torch.empty((B, cols), dtype=torch.bool, device="cuda")
    total = torch.empty((B,), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (reads, hs, is_fw, mask)]
    if S is None:
        err = lib.minimizer_front_full_launch(*ptrs, B, L, k, w, stream)
        out = (hs, is_fw, mask)
    else:
        err = lib.minimizer_front_compact_launch(*ptrs, total.data_ptr(), B,
                                                 L, k, w, S, stream)
        out = (hs, is_fw, mask, total)
    _kernels.check(err, "minimizer_front")
    return out


def main():
    if not torch.cuda.is_available():
        print("time_minimizer_front: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    srcs = [Path(a) for a in sys.argv[1:]] or \
        [_kernels.CSRC / "minimizer_front.cu"]
    inputs = [(label, make_reads(B + L + w, B, L, 0.01), k, w, S)
              for label, B, L, k, w, S in SHAPES]
    libs = {}
    for src in srcs:
        try:
            lib = build(src)
        except RuntimeError as e:
            print(f"{src}: build failed\n{e}", flush=True)
            continue
        bad = []
        for label, reads, k, w, S in inputs:
            got = front(lib, reads, k, w, S)
            want = R.minimizer_front_reference(reads, k, w, S)
            n_bad = sum(int((a != b).sum()) for a, b in zip(got, want))
            if n_bad:
                bad.append(f"{tuple(reads.shape)} k={k} w={w} S={S}: "
                           f"{n_bad} values differ")
        torch.cuda.synchronize()
        print(f"{src}: " + ("; ".join(bad) if bad else
                            f"bit-identical on {len(inputs)} shapes"),
              flush=True)
        if not bad:
            libs[str(src)] = lib
    for label, reads, k, w, S in inputs[:2]:
        times = {name: [] for name in libs}
        order = list(libs) + list(libs)[::-1]
        for _round in range(3):
            for name in order:
                times[name].append(time_ms(
                    lambda: front(libs[name], reads, k, w, S)))
        bound, by = front_bound_ms(reads, k, w, S)
        for name, t in times.items():
            print(f"{label} {tuple(reads.shape)} k={k} w={w} S={S} {name}: "
                  f"median {statistics.median(t):.4f} ms, min {min(t):.4f}, "
                  f"max {max(t):.4f} over {len(t)} (bound {bound:.4f} ms by "
                  f"{by})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
