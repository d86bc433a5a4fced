"""The trace reduction on a hand-made event list: busy time is the union of
the device's operations inside the step window, annotations and NCCL's
waiting kernels are not busy, and each idle gap goes to the host operation
running in it."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from cardbench import trace


def ev(name, start, end, dev=False, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                           is_user_annotation=annotation)


EVENTS = [
    ev("ProfilerStep#1", 100, 200),
    ev("aten::mm", 100, 112), ev("cudaLaunchKernel", 110, 111),
    ev("gemm", 105, 130, dev=True), ev("gemm", 125, 140, dev=True),
    ev("aten::item", 140, 170),
    ev("ncclDevKernel_SendRecv", 140, 160, dev=True), ev("nccl:recv 1<-0", 140, 160, dev=True,
                                                          annotation=True),
    ev("flash_fwd_kernel", 170, 190, dev=True),
    ev("ProfilerStep#1", 150, 190, dev=True, annotation=True),
    ev("late", 195, 230, dev=True),
]


def test_summarize():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6)
    # gemm 105..140, flash 170..190, late clipped to 195..200
    assert s["busy_s"] == pytest.approx(60e-6)
    assert "nccl:recv 1<-0" not in s["kernels"] and "ProfilerStep#1" not in s["kernels"]
    assert s["kernels"]["gemm"] == [pytest.approx(40e-6), 2]
    assert s["kernels"]["ncclDevKernel_SendRecv"][1] == 1
    # gaps: 100..105 in aten::mm, 140..170 in aten::item, 190..195 in host code
    assert s["gaps"] == {"aten::mm": pytest.approx(5e-6), "aten::item": pytest.approx(30e-6),
                         "host code between operations": pytest.approx(5e-6)}
    assert s["idle_gaps"][0][0] == "aten::item"
    assert s["device_ops"][0] == ["gemm", pytest.approx(40e-6)]


def test_combine_averages_ranks():
    a, b = trace.summarize(EVENTS), trace.summarize(EVENTS[:6] + [EVENTS[-1]])
    c = trace.combine([a, b])
    assert c["busy_s"] == pytest.approx((a["busy_s"] + b["busy_s"]) / 2)
    assert c["kernels"]["gemm"] == [pytest.approx(80e-6), 4]
