"""mfu.prefill.energy: the same reading as ``mfu.prefill``,
in the cells that hold no ttft_p90_ms; there it moves j_per_tok."""
from bench.readers import reader

read = reader("mfu.prefill")
