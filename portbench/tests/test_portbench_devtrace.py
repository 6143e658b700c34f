"""The device trace's reduction on synthetic events."""

import pytest

from portbench.harness.devtrace import Event, device_seconds, reduce


def _events(*device, cpu=()):
    out = [Event("window", 0, 1000, False, 1)]
    out += [Event(n, s, e, True) for n, s, e in device]
    out += [Event(n, s, e, False, 1) for n, s, e in cpu]
    return out


def test_idle_share_is_the_window_less_the_union_of_device_events():
    r = reduce(_events(("k1", 100, 300), ("k2", 200, 400), ("copy", 900, 950)))
    assert r["busy_s"] == pytest.approx(350e-9)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["idle_pct"] == pytest.approx(65.0)


def test_events_outside_the_window_are_clipped():
    r = reduce(_events(("k1", -100, 100), ("k2", 950, 1200)))
    assert r["busy_s"] == pytest.approx(150e-9)


def test_device_annotations_are_not_work():
    evs = _events(("k1", 100, 200)) + [Event("entry", 0, 1000, True, 0, True)]
    assert reduce(evs)["idle_pct"] == pytest.approx(90.0)


def test_no_device_event_in_the_window_fails():
    with pytest.raises(ValueError):
        reduce(_events(("k1", 1100, 1200)))


def test_idle_time_is_split_by_what_the_host_did():
    cpu = (("convert", 0, 300), ("entry", 300, 900), ("aten::add", 400, 500),
           ("pull", 900, 1000))
    r = reduce(_events(("k1", 450, 600), ("k2", 700, 800), cpu=cpu))
    gaps = dict(r["idle_gaps"])
    assert gaps == pytest.approx({"convert > (no op)": 300e-9, "entry > (no op)": 300e-9,
                                  "pull > (no op)": 100e-9, "entry > aten::add": 50e-9})
    assert sum(gaps.values()) == pytest.approx(1e-6 - r["busy_s"])


def test_device_ops_ranked_and_summed_by_name():
    r = reduce(_events(("sweep_cost_kernel<float>", 0, 100), ("memset", 100, 110),
                       ("sweep_cost_kernel<float>", 200, 260)))
    assert r["device_ops"][0] == ["sweep_cost_kernel<float>", pytest.approx(160e-9)]
    assert device_seconds(r, "sweep_cost_kernel") == pytest.approx(160e-9)


class _Kineto:
    """A profiler event as torch's Kineto results give it."""

    def __init__(self, name, start, end, device, annotation=False, kind=None):
        import torch

        self._v = (name, start, end, annotation)
        self._dev = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._dev

    def start_thread_id(self):
        return 1

    def is_user_annotation(self):
        return self._v[3]


@pytest.mark.parametrize("with_kind", [True, False])
def test_profiler_events_with_and_without_activity_type(with_kind):
    from types import SimpleNamespace

    from portbench.harness.devtrace import profiler_events

    kind = "gpu_user_annotation" if with_kind else None
    raw = [_Kineto("window", 0, 1000, False, True), _Kineto("k1", 100, 300, True),
           _Kineto("entry", 0, 1000, True, not with_kind, kind)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: raw)))
    events = profiler_events(prof)
    assert [e.annotation for e in events] == [True, False, True]
    assert reduce(events)["busy_s"] == pytest.approx(200e-9)
