"""The caller thread's CPU time inside ``pairhmm_logp_pairs``, ms a
call, over every call of the untraced window (``time.thread_time_ns``
around the entry; any spin of the CUDA runtime while the call waits for
its results is CPU time and counts)."""


def read(ctx):
    if ctx.service.unit != "pairs":
        return None
    done = ctx.window.done()
    if not done:
        return None
    return sum(r.cpu_ns for r in done) / len(done) / 1e6
