"""The share of the cell slots K5 sweeps that lie inside the pairs'
matrices, over the traced window's calls, %.

The program gives each ``pairhmm.launch`` span of ``pairhmm_logp_pairs``
its kernel (``kernel``) and, for K5, its launch's ``cells`` (sum of
rlen x hlen) and ``slots`` (sum of 32 x the bucket's rows a thread x
diagonals, by the kernel's rule; ``ops/pairhmm.py`` ``_k5_work``),
counted when ``spans.spans()`` reads the span, here.  The figure is the
K5 launches' cells over their slots.  None where ``entryspans.per_call_ms``
finds no calls to read, no launch of the window's calls is K5's, or a K5
launch lacks the counts.
"""
import entryspans

LAUNCH = "pairhmm.launch"


def read(ctx):
    if entryspans.per_call_ms(ctx, (LAUNCH,)) is None:
        return None
    from falcon_genome_tpu_torch.utils import spans
    recorded = spans.spans()
    calls = {s.call for s in recorded if s.name == entryspans.CALL}
    launches = [s.attrs for s in recorded
                if s.name == LAUNCH and s.call in calls
                and s.attrs.get("kernel") == "K5"]
    if not launches or any("cells" not in a or "slots" not in a
                           for a in launches):
        return None
    slots = sum(a["slots"] for a in launches)
    return 100.0 * sum(a["cells"] for a in launches) / slots if slots \
        else None
