"""The profiler reduction on hand-made events."""
import pytest

import _helpers  # noqa: F401
from bench.harness import trace

STENCIL = ("void (anonymous namespace)::stencil5_kernel<double>(double "
           "const*, double const*, double*, int, int, long long)")
STEP = ("void (anonymous namespace)::step_kernel<double, (anonymous "
        "namespace)::Dots2>((anonymous namespace)::Args<double>)")


def test_short_names():
    assert trace.short(STENCIL) == "stencil5_kernel<double>"
    assert trace.short(STEP) == "step_kernel<double, Dots2>"
    assert trace.short("aten::mul") == "aten::mul"


def test_reduce_busy_gaps_and_breakdown():
    host = [(0, 100, trace.WINDOW), (5, 40, "bench.solve"),
            (10, 20, "cudaLaunchKernel"), (50, 90, "aten::item")]
    device = [(12, 30, STENCIL), (25, 35, STEP), (60, 70, STEP),
              (95, 120, STEP)]     # the last one runs past the window
    r = trace.reduce(device, host)
    assert r["window_s"] == pytest.approx(100e-9)
    assert r["busy_s"] == pytest.approx((35 - 12 + 10 + 5) * 1e-9)
    assert r["kernel_s"]["step_kernel<double, Dots2>"] == \
        pytest.approx(25e-9)
    gaps = dict(r["idle_gaps"])
    # each gap goes to the innermost host event over its middle: 0-12
    # (middle 6) to the solve's span, 35-60 (47) to none, 70-95 (82) to
    # the item read
    assert gaps == pytest.approx({"bench.solve": 12e-9,
                                  "no host event": 25e-9,
                                  "aten::item": 25e-9})
    assert r["device_ops"][0][0] == "step_kernel<double, Dots2>"
