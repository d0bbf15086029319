"""ttft_p90_ms: the 90th percentile (linear between order statistics), over
every request whose first token came in the window, of the time from its
submission to the end of its prefill iteration."""
import numpy as np


def read(rec):
    x = [(s.t_first - s.t_submit) * 1e3 for s in rec.first_in_window]
    return float(np.percentile(x, 90)) if x else None
