"""The trace's interval arithmetic and the FLOP and byte counts, against
hand-counted cases."""

import math

import pytest

from benchmark.harness import flops
from benchmark.harness.trace import (
    WINDOW_RANGE,
    DeviceEvent,
    HostEvent,
    breakdown,
    innermost_at,
    reduce_events,
    union_length,
)


def test_union_counts_overlap_once_and_lists_the_gaps():
    covered, gaps = union_length([(10, 20), (15, 30), (40, 50), (45, 46), (90, 120)], 0, 100)
    assert covered == 20 + 10 + 10
    assert gaps == [(0, 10), (30, 40), (50, 90)]


def test_union_clips_to_the_window():
    covered, gaps = union_length([(-5, 5), (95, 200)], 0, 100)
    assert covered == 10 and gaps == [(5, 95)]


def test_innermost_host_event():
    host = [HostEvent("outer", 0, 100, 1, 0), HostEvent("inner", 10, 20, 2, 0),
            HostEvent("late", 50, 60, 3, 0)]
    assert innermost_at(host, [5, 15, 20, 55, 99, 150]) == [
        "outer", "inner", "outer", "late", "outer", None]


def _trace():
    host = [HostEvent(WINDOW_RANGE, 0, 1000, 1, 7),
            HostEvent("gru_fwd", 100, 150, 2, 7),
            HostEvent("aten::mm", 300, 320, 3, 7),
            HostEvent("cudaLaunchKernel", 310, 315, 900, 7, runtime=True),
            HostEvent("gru_bwd", 400, 420, 4, 7),
            HostEvent("cudaLaunchKernel", 405, 410, 901, 7, runtime=True),
            HostEvent("aten::item", 600, 900, 5, 7)]
    device = [DeviceEvent("gru_fwd_kernel", 160, 260, linked=2),      # by its range
              DeviceEvent("gemm", 330, 400, linked=3),               # an aten op's
              DeviceEvent("gru_walk_kernel", 420, 520, linked=0, corr=901),  # by its call
              DeviceEvent("void (anonymous namespace)::attention_bwd_head_kernel<2>(float)", 520,
                          560, linked=0),                              # by its name
              DeviceEvent("late", 990, 1100, linked=0)]
    table = {"::attention_bwd_": "attention_bwd"}
    return reduce_events(device, host, {"gru_fwd", "gru_bwd", "attention_bwd"}, table)


def test_reduce_attributes_kernels_and_names_the_gaps():
    red = _trace()
    assert red.window == (0, 1000)
    assert red.busy_ns == 100 + 70 + 100 + 40 + 10
    assert red.by_range == {"gru_fwd": 100, "gru_bwd": 100, "attention_bwd": 40}
    assert red.unattributed == {"gemm": 70, "late": 10}
    # gaps: 0-160, 260-330, 400-420, 560-990 (window range / aten::mm / gru_bwd / item)
    assert red.idle_by_host == {WINDOW_RANGE: 160 + 70, "gru_bwd": 20, "aten::item": 430}
    assert math.isclose(red.busy_s + sum(red.idle_by_host.values()) / 1e9, red.window_s)
    out = breakdown(red, top=2)
    assert out["device_ops"] == [["range gru_fwd", 1e-7], ["range gru_bwd", 1e-7]]
    assert out["idle_gaps"][0] == ["aten::item", 4.3e-7]


def test_least_seconds_takes_the_slower_bound():
    assert flops.least_seconds(3.35e12) == pytest.approx(1.0)
    assert flops.least_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert flops.least_seconds(0.0, 0.0, 495e12) == pytest.approx(1.0)
    assert flops.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_gru_counts_by_hand():
    # rows 2, T 3, H 4: xi 2*3*12, Wh 48, b 12, h 8 floats; products 2*2*3*4*12
    assert flops.gru_fwd(2, 3, 4, False) == pytest.approx(
        max(4 * (72 + 48 + 12 + 8) / flops.HBM_RATE, 240 / flops.F32_PEAK,
            3 * 576 / flops.TF32_PEAK))
    assert flops.gru_fwd(2, 3, 4, True) == pytest.approx(4 * (140 + 96) / flops.HBM_RATE)
    walk_products = 2 * 2 * 2 * 4 * 12 + 2 * 2 * 3 * 4 * 12
    n_bytes = 4 * (2 * 3 * 40 + 8 + 2 * 48 + 12)
    assert flops.gru_bwd(2, 3, 4) == pytest.approx(
        max(n_bytes / flops.HBM_RATE, (720 + 72) / flops.F32_PEAK,
            3 * walk_products / flops.TF32_PEAK))


def test_attention_counts_by_hand():
    # 2 days of 5 rows (7 valid), K 3, H 4
    f = 3 * 7 * 22 + 3 * 3 * 40
    b = 4 * (40 + 3 * 44 + 24) + 10
    assert flops.attention_fwd(2, 5, 3, 4, 7, keep=False) == pytest.approx(
        max(b / flops.HBM_RATE, f / flops.F32_PEAK))
    assert flops.attention_fwd(2, 5, 3, 4, 7, keep=True) == pytest.approx(
        max((b + 4 * 30) / flops.HBM_RATE, f / flops.F32_PEAK))
    fb = 3 * 7 * 58 + 2 * 3 * 80 + 3 * 100
    bb = 4 * (80 + 30 + 2 * 3 * 44 + 24) + 10
    assert flops.attention_bwd(2, 5, 3, 4, 7) == pytest.approx(
        max(bb / flops.HBM_RATE, fb / flops.F32_PEAK))


def test_model_flops_by_hand():
    m = {"num_features": 2, "seq_len": 3, "hidden_size": 4, "num_factors": 5,
         "num_portfolios": 6}
    per_row = 2 * 3 * 4 + 2 * 3 * 2 * 12 + 2 * 3 * 4 * 12 + 32 + 16 + 40 + 20 + 80
    per_day = 5 * 40 + 5 * 48
    assert flops.forward_flops_per_window(m, 10, train=False) == pytest.approx(
        per_row + per_day / 10)
    train = per_row + 48 + 12 + (per_day + 120) / 10
    assert flops.train_flops_per_window(m, 10) == pytest.approx(3 * train)


def test_the_capture_reads_the_window_and_the_host_ranges():
    import torch

    from benchmark.harness.trace import Capture

    cap = Capture(enabled=True)
    with cap.window():
        with torch.profiler.record_function("gru_fwd"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    cap.read()
    names = {e.name for e in cap.host}
    assert {WINDOW_RANGE, "gru_fwd"} <= names
    window = next(e for e in cap.host if e.name == WINDOW_RANGE)
    inner = next(e for e in cap.host if e.name == "gru_fwd")
    assert window.start <= inner.start <= inner.end <= window.end
    assert cap.device == [] and cap.prof is None
