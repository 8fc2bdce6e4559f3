"""The readers of the program's own spans and counters
(`program_spans.py`) on hand-built spans."""
from types import SimpleNamespace

import pytest

from bench_port import program_spans, run, trace as T

MAIN, WORKER = 1, 2
#: One call's spans: (name, start, end, thread), from its start.  The
#: main thread's steps tile the call but for [1.4, 1.5), where only the
#: worker's `align.vote` and the `align` layer run.
STEPS = [("entry.load", 0.0, 0.4, MAIN),
         ("recruit", 0.4, 1.4, MAIN),
         ("recruit.index", 0.4, 0.7, MAIN),
         ("recruit.parse", 0.7, 0.9, MAIN),
         ("recruit.dispatch", 0.9, 1.1, MAIN),
         ("recruit.decide", 1.1, 1.4, MAIN),
         ("align", 1.4, 2.4, MAIN),
         ("align.vote", 1.4, 1.8, WORKER),
         ("align.jobs", 1.8, 1.9, WORKER),
         ("align.wait", 1.5, 1.9, MAIN),
         ("align.dispatch", 1.9, 2.0, MAIN),
         ("align.post", 2.0, 2.4, MAIN),
         ("solve", 2.4, 3.7, MAIN),
         ("solve.prep", 2.4, 2.8, MAIN),
         ("solve.filter", 2.8, 2.9, MAIN),
         ("solve.stage1", 2.9, 3.3, MAIN),
         ("solve.stage2", 3.3, 3.6, MAIN),
         ("solve.final", 3.6, 3.7, MAIN),
         ("entry.write", 3.7, 3.8, MAIN)]
#: Device intervals of one call, from its start: idle gaps [0, 0.9),
#: [1.2, 1.95), [2.2, 2.9), [3.4, 3.8): 2.75 s, all named but [1.4, 1.5).
BUSY = [(0.9, 1.2), (1.95, 2.2), (2.9, 3.4)]


def make_spans(call_id, t0, counters):
    root = SimpleNamespace(name="genotype", id=call_id, parent=None,
                           call=call_id, thread=MAIN, start=t0,
                           end=t0 + 3.8, attrs=counters)
    out, layers = [], {}
    for i, (name, a, b, thread) in enumerate(STEPS):
        layer = name.partition(".")[0]
        parent = layers.get(layer, root) if "." in name else root
        s = SimpleNamespace(name=name, id=call_id + 1 + i, parent=parent,
                            call=call_id, thread=thread, start=t0 + a,
                            end=t0 + b, attrs={})
        if "." not in name:
            layers[name] = s
        out.append(s)
    return out + [root]


@pytest.fixture
def tr(monkeypatch):
    """Two calls inside the window (0, 10) at 0.1 and 4.1, a warm-up call
    before it."""
    kept = (make_spans(100, -5.0, {"k2_chains": 9999, "k2_launches": 1})
            + make_spans(200, 0.1, {"k2_chains": 1024, "k2_launches": 2})
            + make_spans(300, 4.1, {"k2_chains": 2048, "k2_launches": 6}))
    monkeypatch.setattr(program_spans, "records", lambda: kept)
    t = T.Trace(window=(0.0, 10.0), calls=[(0.0, 4.0), (4.0, 10.0)])
    t.busy = [(t0 + a, t0 + b) for t0 in (0.1, 4.1) for a, b in BUSY]
    t.device_ops = [("k", a, b - a) for a, b in t.busy]
    return t


def read(name, tr):
    return run.load_reader(run.Spec("hla_abc_sr.locus_reads"), name)(tr)


@pytest.mark.parametrize("name, value", [
    ("entry_load_s", 0.4), ("entry_write_s", 0.1),
    ("recruit_index_s", 0.3), ("recruit_parse_s", 0.2),
    ("align_vote_s", 0.4), ("align_jobs_s", 0.1), ("align_wait_s", 0.4),
    ("align_post_s", 0.4), ("solve_prep_s", 0.4), ("solve_filter_s", 0.1),
    ("solve_stages_s", 0.7),
    # 2.65 of 2.75 idle seconds in each call lie in a main-thread step.
    ("idle_named_pct", 100.0 * 2.65 / 2.75),
    ("anneal_chains_per_launch", 3072 / 8)])
def test_each_reader_gives_its_hand_worked_value(tr, name, value):
    assert read(name, tr) == pytest.approx(value)


def test_a_gap_is_split_across_the_steps_it_spans(tr):
    """The one gap of each call, [1.2, 1.95): recruit.decide 0.2 s, no
    main-thread step 0.1 s (the worker's align.vote and the layer do not
    name it), align.wait 0.4 s, align.dispatch 0.05 s."""
    tr.busy = [(t0 + a, t0 + b) for t0 in (0.1, 4.1)
               for a, b in ((0.0, 1.2), (1.95, 3.8))]
    tr.device_ops = [("k", a, b - a) for a, b in tr.busy]
    assert read("idle_named_pct", tr) == pytest.approx(100 * 0.65 / 0.75)


@pytest.mark.parametrize("name", ["entry_load_s", "align_vote_s",
                                  "solve_stages_s", "idle_named_pct",
                                  "anneal_chains_per_launch"])
def test_no_program_call_in_the_window_reads_none(tr, monkeypatch, name):
    tr.window = (20.0, 30.0)
    assert read(name, tr) is None
    monkeypatch.setattr(program_spans, "records", lambda: None)
    tr.window = (0.0, 10.0)
    assert read(name, tr) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """The parent of this change has no `utils.spans`: every reader of the
    program's spans gives None and raises nothing."""
    import builtins
    real = builtins.__import__

    def no_spans(name, *a, **k):
        if name.startswith("locityper_tpu_torch"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    assert program_spans.records() is None
    tr = T.Trace(window=(0.0, 1.0), calls=[(0.0, 1.0)],
                 device_ops=[("k", 0.0, 0.5)], busy=[(0.0, 0.5)])
    assert read("align_post_s", tr) is None
    assert read("idle_named_pct", tr) is None


def test_no_launch_reads_none(tr, monkeypatch):
    kept = make_spans(200, 0.1, {"k2_chains": 1024, "k2_launches": 0})
    monkeypatch.setattr(program_spans, "records", lambda: kept)
    assert read("anneal_chains_per_launch", tr) is None


def test_the_program_recorder_is_read(monkeypatch):
    """Spans of the port's own recorder, on the same clock."""
    import time

    from locityper_tpu_torch.utils import spans
    t0 = time.perf_counter()
    with spans.call("genotype"):
        with spans.span("solve"):
            with spans.span("solve.filter"):
                time.sleep(0.01)
        spans.count("k2_chains", 512)
        spans.count("k2_launches", 1)
    tr = T.Trace(window=(t0, time.perf_counter()), calls=[(t0, t0 + 1)])
    assert read("solve_filter_s", tr) >= 0.01
    assert read("anneal_chains_per_launch", tr) == 512
