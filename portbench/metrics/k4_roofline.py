"""K4's share of its roofline over the traced window.

The least time the card could take for the window's PairHMM launches
(``roofline.pairhmm_work`` at each pair's real lengths, against 67
TFLOP/s and 3.35 TB/s) over K4's device time in the trace
(``pairhmm_kernel<NR, false, ...>``, the scalar-transition instance).
The traced window holds every one of its calls' launches and no other.
"""
import roofline


def read(ctx):
    calls = ctx.traced.records
    busy = ctx.trace.kernel_s(roofline.K4_KERNEL)
    if not calls or busy <= 0 or "k4" not in ctx.service.kernel_work(0):
        return None
    least = sum(roofline.bound_s(*ctx.service.kernel_work(r.item)["k4"],
                                 roofline.PEAK_F32_FLOPS) for r in calls)
    return 100.0 * least / busy
