"""The frame loop's host spans and synchronizing-call counter
(scavislam_tpu_torch.utils.perfmon.Spans) on their own: the fold's
totals, self times and counts on a scripted clock, the switch, the
profiler's clock and the counter's deltas."""

import gc
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scavislam_tpu_torch.utils import perfmon


class _Owner:
    def __init__(self, on):
        self.timing_log = [] if on else None
        self.spans = perfmon.Spans(self)


def _owner(on=True):
    return _Owner(on)


@pytest.fixture
def clock(monkeypatch):
    """perf_counter as 0, 1, 2, ... seconds, one tick a read."""
    t = iter(range(1000))
    monkeypatch.setattr(perfmon, "perf_counter", lambda: float(next(t)))


def test_fold_totals_self_and_counts(clock):
    o = _owner()
    sp = o.spans
    with sp.span("a"):              # 0 .. 9
        with sp.span("b"):          # 1 .. 4
            with sp.span("c"):      # 2 .. 3
                pass
        with sp.span("b"):          # 5 .. 8
            with sp.span("c"):      # 6 .. 7
                pass
    with sp.span("d"):              # 10 .. 11
        pass
    f = sp.fold()
    assert f["spans"] == {"a": (9.0, 3.0, 1), "b": (6.0, 4.0, 2),
                          "c": (2.0, 2.0, 2), "d": (1.0, 1.0, 1)}
    # the roots' totals are the sum of every span's self time
    assert sum(s for _, s, _ in f["spans"].values()) == 9.0 + 1.0
    assert sp.last_s == 1.0  # d closed last
    assert perfmon.span_s(f, "b") == 6.0 and perfmon.span_s(f, "x") == 0.0
    # a fold takes only what came after the last one
    assert sp.fold() == {"spans": {}, "syncs": {}}


def test_a_span_closes_on_an_exception(clock):
    o = _owner()
    sp = o.spans
    with pytest.raises(ValueError):
        with sp.span("a"):
            raise ValueError
    with sp.span("b"):
        pass
    assert sp.fold()["spans"] == {"a": (1.0, 1.0, 1), "b": (1.0, 1.0, 1)}


def test_off_reads_no_clock_and_records_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with timing_log None")

    monkeypatch.setattr(perfmon, "perf_counter", no_clock)
    o = _owner(on=False)
    a, b = o.spans.span("a"), o.spans.span("b")
    assert a is b  # one shared no-op context
    with a:
        with b:
            pass
    assert o.spans.fold()["spans"] == {}


def test_the_switch_is_the_owners_timing_log(clock):
    o = _owner(on=False)
    with o.spans.span("a"):
        pass
    o.timing_log = []
    with o.spans.span("b"):
        pass
    assert list(o.spans.fold()["spans"]) == ["b"]


def test_syncs_count_whatever_the_switch_and_fold_as_deltas():
    o = _owner(on=False)
    o.spans.sync("frame.read")
    o.spans.sync("spawn.upload", 2)
    assert o.spans.fold()["syncs"] == {"frame.read": 1, "spawn.upload": 2}
    o.spans.sync("spawn.upload", 2)
    assert o.spans.fold()["syncs"] == {"spawn.upload": 2}
    assert o.spans.fold()["syncs"] == {}
    assert o.spans.syncs == {"frame.read": 1, "spawn.upload": 4}


def test_spans_are_on_the_profilers_clock(monkeypatch):
    entered = []
    real = perfmon.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(perfmon, "record_function", counting)
    o = _owner()
    with o.spans.span("outside"):
        pass
    assert entered == []  # no profiler: no record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with o.spans.span("frontend.consume"):
            with o.spans.span("step.launch"):
                torch.ones(4).add_(1)
    assert entered == ["frontend.consume", "step.launch"]
    names = {e.name for e in prof.events()}
    assert {"frontend.consume", "step.launch"} <= names
    # and the host clock still records them
    assert set(o.spans.fold()["spans"]) == {"outside", "frontend.consume",
                                           "step.launch"}


def test_spanned_method(clock):
    class Owner:
        timing_log = []

        def __init__(self):
            self.spans = perfmon.Spans(self)

        @perfmon.spanned("work")
        def work(self, x, y=1):
            """Adds."""
            return x + y

    o = Owner()
    assert o.work(2, y=3) == 5
    assert Owner.work.__doc__ == "Adds."
    assert o.spans.fold()["spans"] == {"work": (1.0, 1.0, 1)}


def test_an_owner_is_freed_without_the_cyclic_collector():
    # no reference cycle through its spans: a frontend's (and a pool's)
    # device tensors, pinned buffers and events go when the last
    # reference does, never inside a later CUDA graph capture
    from scavislam_tpu_torch.core.camera import StereoCamera
    from scavislam_tpu_torch.models.frontend import StereoFrontend
    gc.disable()
    try:
        o = _owner()
        ref = weakref.ref(o)
        del o
        assert ref() is None
        cam = StereoCamera.create(97.5, (63.5, 47.5), (128, 96), 0.12)
        fe = StereoFrontend(cam, device="cpu")
        fe.timing_log = []
        with fe.spans.span("x"):
            pass
        ref = weakref.ref(fe)
        del fe
        assert ref() is None
    finally:
        gc.enable()
