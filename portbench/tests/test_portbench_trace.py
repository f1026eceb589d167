"""The trace's reduction: busy time as the union of device intervals in the
window, idle gaps labelled by the innermost host span, kernel time by name."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import trace


def ev(name, s, e, dev=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=s, end=e))


def test_reduce_events():
    cpu = DeviceType.CPU
    events = [
        ev(trace.WINDOW, 0, 100, cpu), ev(trace.WINDOW, 0, 100),  # host span and its mirror
        ev("bundle", 0, 60, cpu), ev("ustar", 10, 40, cpu), ev("ustar", 10, 40),
        ev("void spmv_gather_kernel<float4, 8>", 5, 15),
        ev("elementwise", 12, 20), ev("elementwise", 50, 55), ev("memcpy", 95, 120),
    ]
    r = trace.reduce_events(events, ("bundle", "ustar"))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((15 + 5 + 5) * 1e-6)  # 5-20, 50-55, 95-100
    idle = dict(r["idle_gaps"])
    assert idle["bundle"] == pytest.approx(5e-6)  # 0-5
    assert idle["ustar"] == pytest.approx(30e-6)  # 20-50, its middle in ustar
    assert idle["other"] == pytest.approx(40e-6)  # 55-95, its middle outside every span
    assert sum(idle.values()) + r["busy_s"] == pytest.approx(r["window_s"])
    assert r["k1_launches"] == 1 and r["k1_s"] == pytest.approx(10e-6)
    assert dict(r["device_ops"])["elementwise"] == pytest.approx(13e-6)
