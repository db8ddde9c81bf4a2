"""The wait of ``pairhmm_logp_pairs`` for the card: the copy back of the
likelihoods, behind every kernel queued before it on the stream (span
``pairhmm.wait``), wall ms a call of the traced window."""
import entryspans


def read(ctx):
    return entryspans.per_call_ms(ctx, ("pairhmm.wait",))
