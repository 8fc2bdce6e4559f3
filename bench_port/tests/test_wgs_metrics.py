"""The readers of the FASTQ reader's span and of K3's rows a launch
(`recruit_read_s`, `minimizer_rows_per_launch`) on hand-built spans, and
on a program that has neither."""
from types import SimpleNamespace

import pytest

from bench_port import program_spans, run, trace as T

MAIN, READER = 1, 2
CELLS = ["panel6_sr.wgs_bg", "hla_abc_sr.locus_reads"]


def call_spans(call_id, t0, counters, reads=((0.5, 0.8), (0.8, 1.0))):
    """One call from t0 to t0 + 3: its `recruit` layer, the main thread's
    wait on the reader, and `recruit.read` spans on the reader's thread."""
    root = SimpleNamespace(name="genotype", id=call_id, parent=None,
                           call=call_id, thread=MAIN, start=t0,
                           end=t0 + 3.0, attrs=counters)
    layer = SimpleNamespace(name="recruit", id=call_id + 1, parent=root,
                            call=call_id, thread=MAIN, start=t0 + 0.4,
                            end=t0 + 1.4, attrs={})
    wait = SimpleNamespace(name="recruit.parse", id=call_id + 2,
                           parent=layer, call=call_id, thread=MAIN,
                           start=t0 + 0.6, end=t0 + 0.9, attrs={})
    out = [layer, wait]
    for i, (a, b) in enumerate(reads):
        out.append(SimpleNamespace(name="recruit.read", id=call_id + 3 + i,
                                   parent=layer, call=call_id,
                                   thread=READER, start=t0 + a,
                                   end=t0 + b, attrs={"pairs": 32768}))
    return out + [root]


def set_records(monkeypatch, kept):
    monkeypatch.setattr(program_spans, "records", lambda: kept)


@pytest.fixture
def tr(monkeypatch):
    """Two calls inside the window (0, 10), a warm-up call before it."""
    set_records(monkeypatch,
                call_spans(100, -5.0, {"k3_rows": 999, "k3_launches": 1})
                + call_spans(200, 0.1, {"k3_rows": 131072, "k3_launches": 2})
                + call_spans(300, 4.1, {"k3_rows": 65536 + 4800,
                                        "k3_launches": 2}))
    return T.Trace(window=(0.0, 10.0), calls=[(0.0, 4.0), (4.0, 10.0)])


@pytest.mark.parametrize("cell", CELLS)
def test_each_reader_gives_its_hand_worked_value(tr, cell):
    spec = run.Spec(cell)
    # 0.3 + 0.2 s of the reader's thread a call, two calls.
    assert run.load_reader(spec, "recruit_read_s")(tr) == pytest.approx(0.5)
    assert run.load_reader(spec, "minimizer_rows_per_launch")(tr) \
        == pytest.approx((131072 + 65536 + 4800) / 4)


def read(name, tr):
    return run.load_reader(run.Spec(CELLS[0]), name)(tr)


@pytest.mark.parametrize("counters", [{"k3_rows": 65536, "k3_launches": 0},
                                      {"k3_rows": 65536}, {}])
def test_no_launch_reads_none(tr, monkeypatch, counters):
    """The CPU's plain version launches nothing; a program without the
    counters (the parent of the change that added them) counts nothing."""
    set_records(monkeypatch, call_spans(200, 0.1, counters))
    assert read("minimizer_rows_per_launch", tr) is None


def test_a_call_without_the_reader_span_reads_none(tr, monkeypatch):
    set_records(monkeypatch, call_spans(200, 0.1, {}, reads=()))
    assert read("recruit_read_s", tr) is None
    tr.window = (20.0, 30.0)
    assert read("recruit_read_s", tr) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    set_records(monkeypatch, None)
    tr = T.Trace(window=(0.0, 1.0), calls=[(0.0, 1.0)])
    assert read("recruit_read_s", tr) is None
    assert read("minimizer_rows_per_launch", tr) is None
