"""Command-line interface (counterpart of reference src/main.rs +
command/mod.rs dispatcher).

    python -m locityper_tpu_torch.cli [--device {cuda,cpu}] <command> ...

Subcommands: add, preproc, genotype, recruit, align, prune, paf-vcf, index.
`--device` is the device the tensor code runs on: `cuda` (the default;
raises when there is no CUDA device) or `cpu` (the plain PyTorch versions
of the kernels).  Nothing picks the CPU by itself.  Before it parses,
`main` keeps freed host pages resident (`utils/malloc.py`).
"""
from __future__ import annotations

import argparse
import sys

from .utils.logging import setup_logging


def main(argv=None):
    setup_logging()
    from .utils.malloc import tune_host_allocator
    tune_host_allocator()
    parser = argparse.ArgumentParser(
        prog="locityper-tpu-torch",
        description="Targeted genotyper (Locityper method) on PyTorch/CUDA")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Device of the tensor code: cuda (raises "
                             "without a CUDA device) or cpu (plain PyTorch "
                             "versions of the kernels) [%(default)s]")
    sub = parser.add_subparsers(dest="command", required=True)

    from .commands import (add, preproc, genotype, recruit, align, prune,
                           paf_vcf, index)
    for mod, name, help_ in [
        (add, "add", "Add locus/loci to the database"),
        (preproc, "preproc", "Preprocess a WGS sample (background distributions)"),
        (genotype, "genotype", "Genotype a sample over database loci"),
        (recruit, "recruit", "Recruit reads to target sequences"),
        (align, "align", "All-vs-all haplotype alignment (PAF output)"),
        (prune, "prune", "Prune similar haplotypes from the database"),
        (paf_vcf, "paf-vcf", "Convert haplotype PAF alignments to VCF"),
        (index, "index", "Index a coordinate-sorted BAM (.bai)"),
    ]:
        p = sub.add_parser(name, help=help_)
        mod.add_args(p)
        p.set_defaults(func=mod.run)

    args = parser.parse_args(argv)
    try:
        return args.func(args)
    except (ValueError, OSError) as e:
        # Clean one-line errors for user mistakes (bad inputs/paths), like
        # the reference's Error enum rendering (err.rs:11-150).  Unexpected
        # exception types still raise with a full traceback.
        import logging
        logging.getLogger("locityper").error("%s", e)
        return 1


if __name__ == "__main__":
    sys.exit(main())
