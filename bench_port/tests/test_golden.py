"""The two cells' inputs, byte for byte: what `run.Cell.draw` writes (the
FASTQ, `add`'s inputs, the saved background model) and the reference's
expected recruitment, as digests recorded from the harness before it took
single long reads.  A change to the generator, the runner or the reference
that moves a byte of either cell fails here."""
import gzip
import hashlib

import pytest
import torch

from bench_port import check, run

#: (cell, seed) -> {what: sha256 hex digest}.
GOLDEN = {
    ('hla_abc_sr.locus_reads', 12345): {
        'fastq':
            'bbeec0ad6050a24ff453cb4b886f7905f034888ebd9d46a17ad4a07037f7efbf',
        'add_inputs':
            'e4ec26df1e4a8b562e27ec4272143523f12c1fd0fdfd0712e245be4c28fb29e7',
        'background':
            '6c957117de4b880ba0be309bee7b57d5b82767ec1a3655f024370a0a64d26497',
        'recruitment':
            '67ddfc45d9955ae4d63a749bddb8057f89e62cd0545d33515723b0df43abb73b',
    },
    ('hla_abc_sr.locus_reads', 8589934599): {
        'fastq':
            '71a5fa8a426215a8129c13e245d216dbe4a0e551e67d73cfdbcc0a0ad714cf26',
        'add_inputs':
            '4c2a00b9213720a9ea7abad54919208ea9af2372f8e4a49a8348a52a181e68c7',
        'background':
            '6c957117de4b880ba0be309bee7b57d5b82767ec1a3655f024370a0a64d26497',
        'recruitment':
            '067b3f6ed8b91d5f85dc9af33501d72177f556ea5ad6c8f61890e60733694fac',
    },
    ('panel6_sr.wgs_bg', 12345): {
        'fastq':
            '21abe5bc0efc04c549b9b8633300264b8a11d6b676216646dc237d13799e5ff9',
        'add_inputs':
            '54f75f3000e9ab2d719f55d4df61904aa45c018dbdbb66cf2e276f155dd39815',
        'background':
            '6c957117de4b880ba0be309bee7b57d5b82767ec1a3655f024370a0a64d26497',
        'recruitment':
            '55098e607b43b33c960e0e0ff499aba05dd932877f0e1dbdb1ec767eed47e200',
    },
    ('panel6_sr.wgs_bg', 8589934599): {
        'fastq':
            '1eefc07c96036d71cfddf3710375b7f8c9dd5a014555764f3a83b7c9992b62aa',
        'add_inputs':
            '35383c268579c27a1c076ddbe20080f67304a620d16038103ff75a18c8f5690f',
        'background':
            '6c957117de4b880ba0be309bee7b57d5b82767ec1a3655f024370a0a64d26497',
        'recruitment':
            'd89b85d75eb5de07552cfe74c82482cae80ec0e5203c24bff1fe1fecc2ba2113',
    },
}


def digests(workload, seed, work):
    """{what: sha256} of a cell's drawn inputs at `seed`."""
    cell = run.Cell(run.Spec(workload), seed, work)
    cell.draw()
    out = {}

    def put(what, chunks):
        h = hashlib.sha256()
        for c in chunks:
            h.update(c)
        out[what] = h.hexdigest()

    put("fastq", (gzip.decompress(p.read_bytes())
                  for files in cell.fastq for p in files))
    put("add_inputs", [cell.ref.read_bytes(), cell.bed.read_bytes()]
        + [open(cell.haps.format(lc.name), "rb").read() for lc in cell.loci])
    put("background", [gzip.decompress(
        (cell.prep / "bg" / "distr.json.gz").read_bytes())])
    calls = [(i, i, None) for i in range(len(cell.samples))]
    expected = check.expected_recruitment(
        calls, cell.loci, cell.genome, cell.starts, cell.samples, cell.flank,
        torch.device("cpu"))
    put("recruitment", (f"{c}\t{locus}\t{name}\n".encode()
                        for c in sorted(expected)
                        for locus in sorted(expected[c])
                        for name in sorted(expected[c][locus])))
    return out


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_paired_cells_draw_as_before(key, tmp_path):
    workload, seed = key
    assert digests(workload, seed, tmp_path) == GOLDEN[key]
