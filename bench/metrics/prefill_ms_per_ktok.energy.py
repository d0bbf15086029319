"""prefill_ms_per_ktok.energy: the same reading as ``prefill_ms_per_ktok``,
in the cells that hold no ttft_p90_ms; there it moves j_per_tok."""
from bench.readers import reader

read = reader("prefill_ms_per_ktok")
