"""The benchmark's arithmetic on fixed inputs."""

import pytest

from portbench import harness, stats


def test_window_mean_is_the_window_over_its_frames():
    assert stats.window_mean_ms(3.0, 10) == pytest.approx(300.0)
    with pytest.raises(ValueError):
        stats.window_mean_ms(1.0, 0)


@pytest.mark.parametrize("values, q, want", [
    (list(range(1, 11)), 90, 9),
    (list(range(1, 101)), 90, 90),
    ([5.0], 90, 5.0),
    ([3, 1, 2], 50, 2),
    (list(range(1, 12)), 90, 10),
])
def test_percentile_is_nearest_rank(values, q, want):
    assert stats.percentile(values, q) == want


def test_busy_union_and_idle_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.8), (8, 9)]
    assert stats.union_busy(spans) == pytest.approx(5.0)
    assert stats.idle_gaps(spans) == [(3, 5), (6, 8)]
    assert stats.union_busy([]) == 0.0


def test_cull_bound_takes_the_larger_of_bytes_and_operations():
    # the flagship B3 batch: 2,073,600 rays, all live, 3,072 boxes
    rays, boxes = 2_073_600, 3072
    ops_s = rays * boxes * stats.SLAB_TEST_OPS / stats.FP32_OPS_PER_S
    got = stats.cull_bound_s(rays, rays, boxes, rays)
    assert got == pytest.approx(ops_s)
    assert got * 1e3 == pytest.approx(2.5671, rel=1e-3)  # chip_smoke's B3
    # no live ray: only the bytes remain
    nbytes = rays * 32 + boxes * 24 + rays * 4
    assert stats.cull_bound_s(rays, 0, boxes, rays) == pytest.approx(
        nbytes / stats.HBM_BYTES_PER_S)


def test_profile_reading_leaves_out_the_benchmarks_own_kernels():
    events = [
        ("portbench:frame", False, 0, 100), ("portbench:frame", True, 1, 99),
        ("gemm", True, 10, 20), ("portbench-own:sample", False, 30, 40),
        ("portbench-own:sample", True, 41, 48), ("gather", True, 41, 44),
        ("gather", True, 45, 48), ("add", True, 50, 60),
        ("portbench:trace", False, 49, 70), ("portbench:trace", True, 50, 60),
    ]
    got = harness.read_events(events)
    assert got["kernels"] == [("gemm", 10, 20), ("add", 50, 60)]
    assert got["annotations"] == [("frame", 0, 100), ("trace", 49, 70)]
    assert got["own"] == 2
