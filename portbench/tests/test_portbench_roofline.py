"""The kernels' operation and byte counts against hand counts."""
import pytest

import roofline


def test_pairhmm_counts():
    # one pair of a 3-base read and a 4-base haplotype: 12 cells of 11
    # flops, 4 last-row cells of 2; bytes 3 + 3 + 4 + 12, and the table
    flops, nbytes = roofline.pairhmm_work([3], [4])
    assert flops == 12 * 11 + 4 * 2
    assert nbytes == 22 + 1024
    flops2, nbytes2 = roofline.pairhmm_work([3, 2], [4, 5])
    assert flops2 == flops + 10 * 11 + 5 * 2
    assert nbytes2 == nbytes + 2 + 2 + 5 + 12


def test_bound_takes_the_larger():
    assert roofline.bound_s(67e12, 0, roofline.PEAK_F32_FLOPS) == \
        pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12, roofline.PEAK_F32_FLOPS) == \
        pytest.approx(1.0)
    assert roofline.bound_s(67e12, 6.7e12, roofline.PEAK_F32_FLOPS) == \
        pytest.approx(2.0)


def test_card_busy_is_the_union_per_card():
    """``devtrace.card_busy_s`` merges each card's overlapping device
    intervals and leaves out host events."""
    import types
    from torch.autograd import DeviceType
    import devtrace

    def ev(dev, card, a, b):
        return types.SimpleNamespace(
            device_type=lambda: dev, device_index=lambda: card,
            start_ns=lambda: a, duration_ns=lambda: b - a)

    events = [ev(DeviceType.CUDA, 0, 0, 10), ev(DeviceType.CUDA, 0, 5, 20),
              ev(DeviceType.CUDA, 0, 30, 40), ev(DeviceType.CUDA, 1, 0, 7),
              ev(DeviceType.CPU, 0, 0, 1000)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    busy = devtrace.card_busy_s(prof)
    assert busy == pytest.approx({0: 30e-9, 1: 7e-9})
