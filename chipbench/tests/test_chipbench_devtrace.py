"""The trace reduction on a hand-made timeline: busy union, idle gaps by
phase and host call, and the device time of named kernels."""

from __future__ import annotations

import numpy as np
import pytest

from chipbench.devtrace import DeviceTrace


def _trace():
    # window [0, 100); ops [10, 30) and [20, 40) overlap, [60, 70), and one
    # op half outside the window
    ops = [("fa_fwd_tc<128>", 10, 30), ("gemm", 20, 40), ("fa_fwd_tc<128>", 60, 70),
           ("gemm", 95, 120)]
    calls = [("cudaLaunchKernel", 45, 50), ("cudaLaunchKernel", 52, 55),
             ("cudaMemcpyAsync", 80, 90)]
    i64 = lambda xs: np.asarray(xs, dtype=np.int64)  # noqa: E731
    return DeviceTrace([o[0] for o in ops], i64([o[1] for o in ops]), i64([o[2] for o in ops]),
                       [c[0] for c in calls], i64([c[1] for c in calls]),
                       i64([c[2] for c in calls]), 0, 100)


def test_busy_is_the_union_inside_the_window():
    t = _trace()
    s, e = t.busy()
    assert s.tolist() == [10, 60, 95] and e.tolist() == [40, 70, 100]
    assert t.busy_s() == pytest.approx(45e-9)
    assert t.op_seconds(("fa_fwd",)) == pytest.approx(30e-9)
    assert t.share_inside([(0, 35), (60, 100)]) == pytest.approx((25 + 10 + 5) / 45)


def test_idle_gaps_by_phase_and_call():
    t = _trace()
    # gaps: [0,10) [40,60) [70,95); phases: prefill [0, 51), decode [51, 100)
    gaps = dict((k, v) for k, v in t.idle_gaps([("prefill", 0, 51), ("decode", 51, 100)]))
    # [0,10) and [40,60) have midpoints in prefill; [70,95) in decode
    assert gaps["prefill: cudaLaunchKernel"] == pytest.approx((5 + 3) * 1e-9)
    assert gaps["prefill: host (no CUDA call)"] == pytest.approx((10 + 20 - 8) * 1e-9)
    assert gaps["decode: cudaMemcpyAsync"] == pytest.approx(10e-9)
    assert gaps["decode: host (no CUDA call)"] == pytest.approx(15e-9)
    assert sum(gaps.values()) == pytest.approx(55e-9)


def test_top_ops_sum_by_name():
    top = _trace().top_ops()
    assert top[0] == ["fa_fwd_tc<128>", pytest.approx(30e-9)]
    assert top[1] == ["gemm", pytest.approx(25e-9)]
