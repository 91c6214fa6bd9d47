"""krasis_tpu_torch.timing's profile rows, on a stand-in for a profile of
the card (the card's tracer does not run on the CPU)."""

from types import SimpleNamespace

import torch

from krasis_tpu_torch import timing

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
QMM = "void (anonymous namespace)::qmm_kernel<1, 8, float>(__nv_bfloat16 const*)"


def _event(key, us, count, device=CUDA):
    return SimpleNamespace(key=key, self_device_time_total=us, count=count, device_type=device)


def test_traced_kernels_leave_out_step_markers_and_head_launches(monkeypatch):
    """The rows keep device kernels only: no step marker, no host op, and
    no throwaway head launch, which is counted instead (its name as the
    card's profiler gives it)."""
    monkeypatch.setattr(timing, "head_kept", 0)
    monkeypatch.setattr(timing, "head_made", 0)
    prof = SimpleNamespace(key_averages=lambda: [
        _event("ProfilerStep#1", 900.0, 1),
        _event("at::cuda::(anonymous namespace)::spin_kernel(long)", 256.0, 244),
        _event(QMM, 2700.0, 20),
        _event("aten::mm", 0.0, 20, CPU)])
    assert timing.traced_kernels(prof) == [(QMM, 2700.0, 20)]
    assert (timing.head_kept, timing.head_made) == (244, timing.HEAD_LAUNCHES)
