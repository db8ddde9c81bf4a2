"""K5's share of its roofline over the traced window.

The least time the card could take for the window's per-base PairHMM
launches (``roofline_pb.pairhmm_pb_work`` at each pair's real lengths,
against 67 TFLOP/s and 3.35 TB/s) over K5's device time in the trace
(``pairhmm_kernel<NR, true, ...>``, the per-base instance).  None where
the service counts no K5 work or the trace holds no K5 launch.
"""
import roofline
import roofline_pb


def read(ctx):
    calls = ctx.traced.records
    if not calls or "k5" not in ctx.service.kernel_work(0):
        return None
    busy = ctx.trace.kernel_s(roofline_pb.K5_KERNEL)
    if busy <= 0:
        return None
    least = sum(roofline.bound_s(*ctx.service.kernel_work(r.item)["k5"],
                                 roofline.PEAK_F32_FLOPS) for r in calls)
    return 100.0 * least / busy
