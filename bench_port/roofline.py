"""Operations and bytes of the port's three main-path kernels, counted from
each launch's shape, and the published peaks of one NVIDIA H100 SXM that
bound them.

The counts are frozen copies of those in the headers of the kernels'
sources (`locityper_tpu_torch/ops/csrc/*.cu`) and of
`chip_smoke.py`'s `align_bound_ms`, `anneal_bound_ms` and `front_bound_ms`:
each input byte is read once and each output byte written once; the work is
what these inputs need (rows of the actual reads, moves the chains
proposed).  The peaks assume the card's full power limit of 700 W; the run
prints the limit it found beside them.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # HBM3 bandwidth, H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # float32 outside the tensor cores

K1_OPS_PER_CELL = 52          # align_banded.cu: one band cell of one row
K2_OPS_PER_MOVE = 232         # anneal_chains.cu: one proposed move
K3_OPS_FIXED, K3_OPS_PER_NEIGHBOUR = 26, 4   # minimizer_front.cu: a position


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """Least seconds the card could take, and which peak sets it."""
    by_ops, by_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")


def align_banded(n_jobs: int, L: int, band: int, rows: int):
    """K1: `rows` = the sum over jobs of min(read length, L).  Reads
    [N, L] int8, lengths [N] int32, windows [N, L + band] int8 and the five
    scores in; a float32 score and six int32 payloads out (the valid flag
    is derived on the host side of the wrapper)."""
    nbytes = (n_jobs * L + 4 * n_jobs + n_jobs * (L + band) + 5 * 4
              + n_jobs * (4 + 6 * 4 + 1))
    return rows * band * K1_OPS_PER_CELL, nbytes


def anneal_chains(in_bytes: int, C: int, R: int, W: int, moves: int):
    """K2: `moves` = the moves the chains proposed (the kernel's
    steps_done); the final re-scoring reads W windows and R reads a chain.
    `in_bytes` is the size of every input tensor; out: likelihood, end
    assignment and steps."""
    nbytes = in_bytes + 4 * C + 4 * C * R + 4 * C
    return moves * K2_OPS_PER_MOVE + C * (W + R), nbytes


def minimizer_front(B: int, L: int, k: int, w: int, S):
    """K3 (compacting entry, S columns) or K5 (full width, S None):
    [B, L] int8 codes in; hash, strand and selection a column out, and a
    count a row when compacting."""
    P = L - k + 1
    cols = P if S is None else S
    nbytes = B * L + B * cols * (4 + 1 + 1) + (0 if S is None else 4 * B)
    return B * P * (K3_OPS_FIXED + K3_OPS_PER_NEIGHBOUR * (w - 1)), nbytes
