"""The caller thread's CPU time inside the wait of
``pairhmm_logp_pairs`` (span ``pairhmm.wait``), ms a call of the traced
window: near the wait's wall time where the wait spins, near 0 where it
sleeps."""
import entryspans


def read(ctx):
    return entryspans.per_call_ms(ctx, ("pairhmm.wait",), cpu=True)
