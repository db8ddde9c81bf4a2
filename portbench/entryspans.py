"""The PairHMM entry's spans in the traced window, a call.

The program records spans inside ``pairhmm_logp_pairs`` while a
``torch.profiler`` session runs (``falcon_genome_tpu_torch/utils/
spans.py``).  In a ``--trace 1`` run the traced window is the only
session, so the spans the program holds when the metrics are read are
that window's.  ``per_call_ms`` gives None in a cell whose service does
not deliver pairs, with a program that records no spans, or where the
``pairhmm.call`` spans are not exactly the traced window's calls.
"""

CALL = "pairhmm.call"


def per_call_ms(ctx, names: tuple[str, ...], cpu: bool = False):
    """The wall time (``cpu``: the thread's CPU time, where the program
    read it) of the spans ``names`` summed over the traced window's
    calls, over its calls, ms."""
    if ctx.service.unit != "pairs":
        return None
    try:
        from falcon_genome_tpu_torch.utils import spans
    except ImportError:
        return None
    recorded = spans.spans()
    calls = {s.call for s in recorded if s.name == CALL}
    n = len(ctx.traced.records)
    if not n or len(calls) != n or \
            sum(s.name == CALL for s in recorded) != n:
        return None
    chosen = [s for s in recorded if s.name in names and s.call in calls]
    if cpu and any(s.cpu_ns is None for s in chosen):
        return None
    return sum(s.cpu_ns if cpu else s.end_ns - s.start_ns
               for s in chosen) / n / 1e6
