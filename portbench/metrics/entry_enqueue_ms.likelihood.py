"""The enqueue of ``pairhmm_logp_pairs``: its seven pageable copies to the
card, the gathers and K4's wrapper and launch (spans ``pairhmm.copy_in``,
``pairhmm.gather`` and ``pairhmm.launch``), wall ms a call of the traced
window."""
import entryspans


def read(ctx):
    return entryspans.per_call_ms(
        ctx, ("pairhmm.copy_in", "pairhmm.gather", "pairhmm.launch"))
