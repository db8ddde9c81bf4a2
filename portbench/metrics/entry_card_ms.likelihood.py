"""The card's time a call outside K4, ms: the traced window's busy time
on the cards (kernels, copies and sets) less K4's, over its calls.  The
copies, gathers and sets that ``pairhmm_logp_pairs`` issues around the
kernel."""
import roofline


def read(ctx):
    calls = ctx.traced.records
    cards = ctx.trace.cards()
    if not calls or not cards or ctx.service.unit != "pairs":
        return None
    busy = sum(ctx.trace.busy_s(c) for c in cards)
    return 1e3 * (busy - ctx.trace.kernel_s(roofline.K4_KERNEL)) / len(calls)
