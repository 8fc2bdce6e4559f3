"""The metric arithmetic on hand-worked traces."""
import pytest

from bench_port import run, trace as T


def spec():
    return run.Spec("hla_abc_sr.locus_reads")


def read(name, tr):
    return run.load_reader(spec(), name)(tr)


def test_sample_seconds_over_whole_calls():
    calls = [(0, 0, None, 10.0, 13.0, 0), (1, 1, None, 13.0, 16.5, 0),
             (2, 2, None, 16.5, 21.0, 0)]
    assert run.sample_seconds(10.0, calls) == pytest.approx(11.0 / 3)


def test_union_of_intervals():
    assert T.merge([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [(0, 2), (3, 5)]


def make_trace():
    tr = T.Trace(window=(0.0, 10.0), calls=[(0.0, 4.0), (4.0, 10.0)])
    tr.spans = {"recruit": [(0.0, 1.0), (4.0, 6.0)],
                "align": [(1.0, 2.0), (6.0, 8.0)],
                "solve": [(2.0, 3.0), (8.0, 9.0)]}
    tr.device_ops = [("align_banded_kernel", 1.0, 0.5),
                     ("align_banded_kernel", 1.25, 0.5),
                     ("minimizer_front_kernel", 4.0, 0.25),
                     ("anneal_chains_kernel", 8.0, 1.5)]
    tr.busy = T.merge((s, s + d) for _, s, d in tr.device_ops)
    tr.launches = {"align_banded": [(67e12 * 0.1, 0)],
                   "anneal_chains": [lambda: (0, 3.35e12 * 0.01)]}
    return tr


def test_layer_seconds_a_sample():
    tr = make_trace()
    assert read("recruit_s", tr) == pytest.approx(1.5)
    assert read("align_s", tr) == pytest.approx(1.5)
    assert read("solve_s", tr) == pytest.approx(1.0)
    assert read("entry_s", tr) == pytest.approx((10.0 - 8.0) / 2)


def test_idle_share_from_the_union():
    tr = make_trace()
    # Busy: [1, 1.75] + [4, 4.25] + [8, 9.5] = 2.5 s of 10.
    assert tr.busy_s == pytest.approx(2.5)
    assert read("device_idle_pct", tr) == pytest.approx(75.0)


def test_rooflines():
    tr = make_trace()
    assert read("align_banded_roofline", tr) == pytest.approx(10.0)
    assert read("anneal_chains_roofline", tr) == pytest.approx(100 / 150)
    # Launches recorded, no device time: nothing to read, never 0.
    assert read("minimizer_front_roofline", tr) is None


def test_breakdown_names_gaps_by_layer():
    tr = make_trace()
    b = T.breakdown(tr)
    assert b["device_ops"][0] == ["anneal_chains_kernel", 1.5]
    # Gaps: [0, 1] recruit, [1.75, 4] solve, [4.25, 8] align, [9.5, 10] in
    # the second call outside every span.
    assert [g[0] for g in b["idle_gaps"]] == ["align", "solve", "recruit",
                                              "entry"]
    assert b["idle_gaps"][0][1] == pytest.approx(3.75)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
