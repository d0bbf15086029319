"""tpot_p90_ms: the 90th percentile, over every request that finished in the
window with at least 2 tokens, of (last token - first token) / (tokens - 1)."""
import numpy as np


def read(rec):
    x = [(s.t_done - s.t_first) * 1e3 / (len(s.tokens) - 1)
         for s in rec.done_in_window if len(s.tokens) >= 2]
    return float(np.percentile(x, 90)) if x else None
