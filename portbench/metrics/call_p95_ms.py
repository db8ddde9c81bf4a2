"""The 95th percentile of the calls' latency over every call of the
untraced window: from the caller's submit to its results on the host,
ms.  A tail of the host entry's wall time a call; a bound on it would be
narrower than its spread on the card's shared host (PERF.md, section 2)."""
import numpy as np


def read(ctx):
    done = ctx.window.done()
    if len(done) < 200:         # ten calls or more beyond the percentile
        return None
    lat = [(r.t_done - r.t_submit) * 1e3 for r in done]
    return float(np.quantile(np.asarray(lat), 0.95))
