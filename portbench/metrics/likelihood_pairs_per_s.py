"""The pairs a second that reached the callers: read x haplotype pairs
whose log10 likelihoods came back inside the untraced window, over the
window, by the host's clock.  What the caller threads get; it follows the
host entry and the card's shared host, whose speed swings from process to
process (PERF.md, section 2), so it is read here and not bounded."""


def read(ctx):
    if ctx.service.unit != "pairs":
        return None
    done = ctx.window.done()
    if not done:
        return None
    return sum(r.units for r in done) / ctx.window.seconds
