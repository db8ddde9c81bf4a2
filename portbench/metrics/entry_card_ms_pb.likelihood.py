"""The card's time a call outside K5, ms: the traced window's busy time
on the cards (kernels, copies and sets) less K5's, over its calls.  The
copies, gathers and the gap continuation's fill that
``pairhmm_logp_pairs`` issues around the kernel on its per-base route.
None where the trace holds no K5 launch (the calls went to K4, whose
reader is ``entry_card_ms.likelihood``)."""
import roofline_pb


def read(ctx):
    calls = ctx.traced.records
    cards = ctx.trace.cards()
    if not calls or not cards or ctx.service.unit != "pairs":
        return None
    k5 = ctx.trace.kernel_s(roofline_pb.K5_KERNEL)
    if k5 <= 0:
        return None
    busy = sum(ctx.trace.busy_s(c) for c in cards)
    return 1e3 * (busy - k5) / len(calls)
