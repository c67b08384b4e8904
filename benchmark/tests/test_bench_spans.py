"""`benchmark/spans.py` on fabricated device events and program spans: each
event put down to the innermost span at its launch (through either of its
correlation ids), the device share of a span with its descendants (the
union of its events), the idle time of the gaps a span's launch ends, and
the idle table that sums to the window's idle time."""

import pytest

from benchmark import spans as spanlib

# request [0, 100] > guidance [10, 50] > guidance_iter [20, 40];
# request > segment [60, 80] > wait:sam_masks_to_host [75, 80].
SPANS = [("request", 0, 100, None), ("guidance", 10, 50, 0), ("guidance_iter", 20, 40, 1),
         ("segment", 60, 80, 0), ("wait:sam_masks_to_host", 75, 80, 3)]
# name, device start, end, correlation ids; the launches below.
DEV = [("k_request", 0, 8, (1, 0)), ("k_iter", 30, 45, (0, 2)), ("k_iter2", 40, 55, (3, 0)),
       ("k_segment", 70, 90, (4, 0)), ("k_unlaunched", 96, 98, (99, 0)),
       ("k_before", -20, -10, (5, 0))]
RUNTIME = [("cudaLaunchKernel", 5, 6, 1), ("cudaLaunchKernel", 25, 26, 2),
           ("cuLaunchKernel", 26, 27, 3), ("cudaLaunchKernel", 65, 66, 4),
           ("cudaLaunchKernel", -30, -29, 5), ("cudaStreamSynchronize", 76, 79, 6),
           ("cudaStreamSynchronize", 30, 31, 7), ("cudaStreamSynchronize", 120, 121, 8)]


@pytest.fixture
def view():
    return spanlib.SpanView(DEV, RUNTIME, SPANS, 0, 100)


def test_events_go_to_the_innermost_span_at_their_launch(view):
    assert len(view.dev) == 5                       # k_before lies outside the window
    assert view.matched == pytest.approx(4 / 5)     # k_unlaunched has no launch event
    names = [SPANS[s][0] if s is not None else None for s in view._dev_span]
    assert names == ["request", "guidance_iter", "guidance_iter", "segment", None]


def test_device_share_counts_descendants_once(view):
    # k_iter and k_iter2 overlap on [40, 45]: the union is [30, 55].
    assert view.device_share({"guidance"}) == pytest.approx(0.25)
    assert view.device_share({"guidance_iter"}) == pytest.approx(0.25)
    assert view.device_share({"segment"}) == pytest.approx(0.20)
    assert view.device_share({"request"}) == pytest.approx(0.53)
    assert view.device_share({"optimizer"}) == 0.0
    assert view.busy_ns == 55


def test_idle_in_takes_the_gaps_a_span_launch_ends(view):
    # Gaps [8, 30] (ended by k_iter), [55, 70] (k_segment), [90, 96]
    # (k_unlaunched: unknown), [98, 100] (the window's end).
    assert [(a, b) for a, b, _ in view.gaps()] == [(8, 30), (55, 70), (90, 96), (98, 100)]
    assert view.idle_in({"guidance"}) == pytest.approx(0.22)
    assert view.idle_in({"segment"}) == pytest.approx(0.15)
    assert view.idle_in({"request"}) == pytest.approx(0.37)


def test_idle_table_sums_to_the_device_idle(view):
    table = view.idle_by_span()
    assert table == pytest.approx({"guidance_iter": 0.22, "segment": 0.15,
                                   spanlib.OUTSIDE: 0.08})
    out = spanlib.readings(view, {"guidance_threshold": 6, "sam_masks_to_host": 2}, 4,
                           training=False)
    assert out["device_idle_pct"] == pytest.approx(45.0)
    assert out["idle_sum_pct"] == pytest.approx(out["device_idle_pct"])
    assert out["guidance_idle_pct"] == pytest.approx(22.0)
    assert out["sam_pct"] == pytest.approx(20.0)
    assert out["syncs_per_image"] == 2.0
    assert out["launches_per_unit"] == pytest.approx(4 / 4)   # the launch at -30 is outside
    assert out["cudaStreamSynchronize_per_unit"] == pytest.approx(2 / 4)
    assert out["cudaDeviceSynchronize_by_span"] == {}


def test_runtime_calls_by_span(view):
    assert view.runtime_by_span(lambda n: n == "cudaStreamSynchronize") == {
        "wait:sam_masks_to_host": 1, "guidance_iter": 1}
    assert view.runtime_by_span(spanlib.is_launch) == {"request": 1, "guidance_iter": 2,
                                                        "segment": 1}


def test_training_readings():
    spans = [("train_step", 0, 100, None), ("cast_params", 0, 10, 0), ("forward", 10, 40, 0),
             ("backward", 40, 80, 0), ("optimizer", 80, 100, 0)]
    dev = [("cast", 2, 12, (1, 0)), ("fwd", 12, 40, (2, 0)), ("bwd", 45, 80, (3, 0)),
           ("adam", 85, 95, (4, 0))]
    runtime = [("cudaLaunchKernel", t, t + 1, i + 1) for i, t in enumerate((1, 11, 41, 81))]
    view = spanlib.SpanView(dev, runtime, spans, 0, 100)
    out = spanlib.readings(view, {}, 1, training=True)
    assert out["param_cast_pct"] == pytest.approx(10.0)
    assert out["optimizer_pct"] == pytest.approx(10.0)
    assert out["idle_by_span_pct"] == pytest.approx({"cast_params": 2.0, "backward": 5.0,
                                                     "optimizer": 5.0, spanlib.OUTSIDE: 5.0})
    assert out["idle_sum_pct"] == pytest.approx(out["device_idle_pct"]) == pytest.approx(17.0)
