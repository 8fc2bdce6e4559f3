"""The port's span recorder (`locityper_tpu_torch/utils/spans.py`) on its
own: what a span keeps, its bounds, threads and counters.  A whole
`genotype` call's spans are held in tests/test_torch_genotype_cmd.py."""
import sys
import threading

import pytest

from locityper_tpu_torch.utils.spans import Recorder, summary


def test_a_span_that_raises_is_closed_and_leaves_the_stack_clean():
    rec = Recorder()
    with rec.call("genotype") as root:
        with pytest.raises(ValueError):
            with rec.span("solve"):
                with rec.span("solve.stage1", chunks=2):
                    raise ValueError("inside a step")
        assert rec.current() is root
    assert rec.current() is None
    stage, layer, call = rec.snapshot()
    assert (stage.name, layer.name, call.name) == ("solve.stage1", "solve",
                                                   "genotype")
    assert stage.parent is layer and layer.parent is call
    assert call.start <= layer.start <= stage.start <= stage.end \
        <= layer.end <= call.end
    assert stage.attrs == {"chunks": 2}
    assert {s.call for s in (stage, layer, call)} == {call.id}


def test_a_call_that_raises_is_closed_and_ends_the_call():
    rec = Recorder()
    with pytest.raises(RuntimeError):
        with rec.call("genotype"):
            rec.count("k1_jobs", 3)
            raise RuntimeError("inside the call")
    (call,) = rec.snapshot()
    assert call.end is not None and call.attrs == {"k1_jobs": 3}
    rec.count("k1_jobs", 1)             # no call open: dropped
    with rec.span("recruit") as outside:
        pass
    assert outside.seconds >= 0 and rec.snapshot() == [call]


def test_the_deque_keeps_the_newest_spans_up_to_its_bound():
    rec = Recorder(maxlen=8)
    with rec.call("genotype"):
        for i in range(20):
            with rec.span("align.post", i=i):
                pass
    kept = rec.snapshot()
    assert len(kept) == 8
    assert [s.attrs["i"] for s in kept[:-1]] == list(range(13, 20))
    assert kept[-1].name == "genotype"


def test_a_worker_thread_names_its_parent():
    rec = Recorder()
    with rec.call("genotype") as root:
        with rec.span("align") as layer:
            def work():
                with rec.span("align.vote", parent=layer):
                    pass
                with rec.span("align.orphan"):
                    pass
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by_name = {s.name: s for s in rec.snapshot()}
    vote, orphan = by_name["align.vote"], by_name["align.orphan"]
    assert vote.parent is layer and vote.call == root.id
    assert orphan.parent is None and orphan.call == root.id
    assert vote.thread != root.thread == layer.thread


def test_counters_from_many_threads_lose_no_update():
    rec = Recorder()
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rec.call("genotype") as root:
            def add():
                for _ in range(n_adds):
                    rec.count("k2_chains", 1)
            threads = [threading.Thread(target=add)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert root.attrs["k2_chains"] == n_threads * n_adds


def test_the_summary_line_gives_layers_steps_and_counters():
    rec = Recorder()
    with rec.call("genotype") as root:
        with rec.span("entry.load"):
            pass
        with rec.span("recruit"):
            with rec.span("recruit.index"):
                pass
        rec.count("pairs_parsed", 10)
    line = summary(root, rec.snapshot())
    assert line.startswith(f"genotype call {root.id}: ")
    assert "entry " in line and "(load " in line
    assert "recruit " in line and "(index " in line
    assert line.endswith("pairs_parsed=10")
    assert "align" not in line
