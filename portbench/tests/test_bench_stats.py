"""The metric arithmetic on synthetic timelines."""

import pytest

from portbench import catalog, run, stats
from portbench.drivers.common import Record
from portbench.metrics import (
    device_idle_pct,
    enqueue_ms,
    env_step_p95_ms,
    envloop_steps_per_s,
    launches_per_step,
    selfplay_steps_per_s,
)


def test_rate_is_all_work_over_the_window():
    rec = Record(work=3 * 16384 * 256, window_s=2.0)
    assert selfplay_steps_per_s.read(rec, "") == 3 * 16384 * 256 / 2.0
    rec = Record(work=1000 * 16384, window_s=1.25)
    assert envloop_steps_per_s.read(rec, "") == 1000 * 16384 / 1.25
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_p95_over_every_step():
    lat = [0.001] * 95 + [0.010] * 5
    rec = Record(latencies_s=lat)
    # The 95th percentile of 100 values lies between the 95th and 96th.
    assert env_step_p95_ms.read(rec, "") == pytest.approx(1.0 + 0.05 * 9)
    assert stats.percentile(range(101), 95) == 95
    assert env_step_p95_ms.read(Record(), "") is None


def test_median_enqueue():
    assert enqueue_ms.read(Record(enqueue_s=[0.003, 0.001, 0.002]), "") == \
        pytest.approx(2.0)
    assert enqueue_ms.read(Record(), "") is None


def test_idle_is_one_minus_the_busy_union():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0)]
    assert stats.busy([(s, e) for _, s, e in ops]) == 2.5
    rec = Record(ops=ops, window_s=5.0, calls=3)
    assert device_idle_pct.read(rec, "device_idle_pct.x") == pytest.approx(50.0)
    assert launches_per_step.read(rec, "") == 1.0
    assert device_idle_pct.read(Record(window_s=1.0), "") is None


@pytest.mark.parametrize("launched, short", [
    ({"rollout_chunk_simple_kernel": 10, "env_merge_kernel": 10}, 0),
    ({"fused_env_step_kernel": 10}, 0),
    ({"rollout_chunk_simple_kernel": 0, "env_merge_kernel": 10}, 10),
    ({"rollout_chunk_simple_kernel": 10, "env_merge_kernel": 7}, 3),
])
def test_launch_check_counts_each_named_kernel(launched, short):
    """A step that fell back to plain code for one of its two kernels is
    short, though the other launched every call."""
    traffic = catalog.resolve("env.mixed_step")["traffic"]
    rec = Record(calls=10, launches=launched)
    assert run.launch_check(rec, traffic) == ("kernel_launches_short", short, 0)


def test_gaps_and_labels():
    ops = [("k", 1.0, 2.0), ("k", 2.5, 3.0)]
    gaps = stats.idle_gaps([(s, e) for _, s, e in ops], 0.0, 4.0)
    assert gaps == [(0.0, 1.0), (2.0, 2.5), (3.0, 4.0)]
    spans = [("outer", 0.0, 4.0), ("inner", 2.0, 2.6)]
    assert stats.label_gaps(gaps, spans) == [["outer", 2.0], ["inner", 0.5]]
    assert stats.top_ops(ops + [("m", 0.0, 0.1)]) == [["k", 1.5], ["m", 0.1]]


class _Event:
    def __init__(self, name, device, start_ns, dur_ns):
        self._v = (name, device, start_ns, dur_ns)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def test_trace_keeps_device_operations_on_the_wall_clock():
    from torch.autograd import DeviceType

    from portbench.trace import device_ops, short_name

    events = [
        _Event("void pomcpp::rollout_chunk_kernel<true>(pomcpp::StateView, "
               "int)", DeviceType.CUDA, 2_000_000_000, 30_000_000),
        _Event("cudaLaunchKernel", DeviceType.CPU, 1_999_000_000, 10_000),
        _Event("Memcpy DtoH (Device -> Pageable)", DeviceType.CUDA,
               2_040_000_000, 1_000),
        _Event("", DeviceType.CUDA, 2_050_000_000, 1_000),
    ]
    ops = device_ops(events)
    assert [o[0] for o in ops] == ["rollout_chunk_kernel<true>",
                                   "Memcpy DtoH", "unnamed"]
    assert ops[0][1:] == pytest.approx((2.0, 2.03))
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::AUnaryFunctor<int, int, bool> >(int)") == \
        "vectorized_elementwise_kernel<...>"
