"""The share of the traced window in which no kernel, copy or set ran
on the card (the mean over the cards used), in a likelihood cell."""


def read(ctx):
    if ctx.service.unit != "pairs":
        return None
    cards = ctx.trace.cards()
    if not cards or ctx.trace.window_s <= 0:
        return None
    n = max(len(cards), ctx.cell.chips)
    busy = sum(ctx.trace.busy_s(c) for c in cards) / n
    return 100.0 * (1.0 - busy / ctx.trace.window_s)
