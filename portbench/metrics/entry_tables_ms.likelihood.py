"""The host tables of ``pairhmm_logp_pairs`` (its seven padded numpy
tables, span ``pairhmm.tables``), wall ms a call of the traced window."""
import entryspans


def read(ctx):
    return entryspans.per_call_ms(ctx, ("pairhmm.tables",))
