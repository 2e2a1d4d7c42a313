"""The benchmark's arithmetic on synthetic inputs: the rate and the p90 of
a call log, the scan's bytes, and the per-layer readers on a trace."""
import pytest

from portbench import harness
from portbench.reference import scan_bytes
from portbench.trace import SPAN, DeviceOp, Summary


def load(folder, name):
    return harness.load_module(harness.PKG / folder / f"{name}.py", name)


def run_of(calls=(), trace=None, facts=None, peak=0, setup_s=1.5):
    return harness.Run(setup_s, list(calls), facts or {}, peak, trace)


def test_rate_is_all_work_over_the_whole_window():
    calls = [(10.0, 10.5, 100), (10.5, 11.25, 300), (11.25, 12.0, 200)]
    assert load("end_to_end", "sim_evals_per_s").read(run_of(calls)) == \
        pytest.approx(600 / 2.0)


def test_p90_is_the_nearest_rank():
    p90 = load("end_to_end", "call_p90_ms")
    walls = [0.001 * (i + 1) for i in range(20)]          # 1..20 ms
    calls = [(0.0, w, 1) for w in walls]
    assert p90.read(run_of(calls)) == pytest.approx(18.0)  # ceil(18) = 18th
    assert p90.p90([5.0]) == 5.0
    assert p90.p90([3.0, 1.0, 2.0]) == 3.0                 # ceil(2.7) = 3rd
    assert p90.p90(list(range(1, 11))) == 9                # ceil(9) = 9th


def test_setup_is_read_as_measured():
    assert load("end_to_end", "setup_s").read(run_of(setup_s=7.25)) == 7.25


def test_scan_bytes_match_the_smoke_tests_count():
    """Phase 3 of the chip smoke test prints 0.949 MB for a launch at
    1024 runs x 20 entries on the 10,140-config GEMM space."""
    assert scan_bytes.launch_bytes(1024, 20, 10140) == 949_296
    assert scan_bytes.least_seconds(1024, 20, 10140) == pytest.approx(
        949_296 / 3.35e12)


def summary():
    """Two calls, 0-100 and 100-200 us; kernels 10-30, 20-40 (overlap),
    50-60, the scan 120-124, a copy 190-199, one after the window; host
    ops over 42-48 and 85-95."""
    ops = [DeviceOp("k1", 10, 30), DeviceOp("k2", 20, 40),
           DeviceOp("k1", 50, 60), DeviceOp("budget_scan_kernel", 120, 124),
           DeviceOp("Memcpy DtoH", 190, 199), DeviceOp("late", 300, 310)]
    host = [(42.0, 48.0, "aten::rand"), (85.0, 95.0, "cudaLaunchKernel")]
    spans = [(0.0, 100.0), (100.0, 200.0)]
    return Summary(ops, host, spans, calls=2)


def test_summary_busy_window_and_gaps():
    s = summary()
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx((30 + 10 + 4 + 9) * 1e-6)
    gaps = s.idle_by_host()
    assert gaps["aten::rand"] == pytest.approx(10e-6)        # 40-50
    assert gaps["cudaLaunchKernel"] == pytest.approx(60e-6)  # 60-120
    assert gaps[SPAN] == pytest.approx(77e-6)   # 0-10, 124-190, 199-200
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert len(b["idle_gaps"]) == 3
    assert [o.name for o in s.kernels()] == ["k1", "k2", "k1",
                                             "budget_scan_kernel"]


def test_per_layer_readers():
    facts = {"runs": 1024, "generations": 2, "popsize": 20, "n_valid": 10140,
             "scan_kernel": "budget_scan_kernel"}
    r = run_of(trace=summary(), facts=facts, peak=3 * 2 ** 29)
    assert load("metrics", "launches_per_gen").read(r) == 1.0   # 4 / (2x2)
    assert load("metrics", "strategy_dev_ms_per_gen").read(r) == \
        pytest.approx(50e-3 / 4)
    assert load("metrics", "scan_roofline").read(r) == pytest.approx(
        100 * 949_296 / 3.35e12 / 4e-6)
    assert load("metrics", "idle_share").read(r) == pytest.approx(
        100 * (1 - 53 / 200))
    assert load("metrics", "peak_mem_gib").read(r) == 1.5
    assert load("metrics", "d2h_ms_per_call").read(r) == pytest.approx(
        9e-3 / 2)                                  # one 9 us copy, 2 calls


def test_readers_return_nothing_without_a_trace():
    r = run_of()
    for name in ("launches_per_gen", "strategy_dev_ms_per_gen",
                 "scan_roofline", "idle_share", "peak_mem_gib",
                 "d2h_ms_per_call"):
        assert load("metrics", name).read(r) is None
    empty = Summary([], [], [(0.0, 10.0)], calls=1)
    r = run_of(trace=empty, facts={"generations": 1, "scan_kernel": "s"})
    for name in ("launches_per_gen", "strategy_dev_ms_per_gen",
                 "idle_share", "d2h_ms_per_call"):
        assert load("metrics", name).read(r) is None
