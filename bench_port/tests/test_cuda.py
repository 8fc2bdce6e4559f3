"""On the card, at a size a test run holds: the program's readings within
the cell's limits, and the control's and the planted faults' beyond them
(`python -m pytest bench_port/tests -q` on a machine with a card)."""
import os

import pytest

from bench_port import control, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hla_abc_sr.locus_reads"])
def test_control_and_faults_fail_the_limits(cell, cuda_device):
    spec = run.Spec(cell)
    line = control.one_seed(spec, 2**40 + 3, 1, True, dict(os.environ),
                            "cuda")
    limits = spec.limits

    def within(numbers):
        return all(numbers[k] <= limits[k] for k in limits)

    assert within(line["program"]), line
    for name in ("control", *control.FAULTS):
        assert not within(line[name]), (name, line[name])
