"""decode_iter_ms.energy: the same reading as ``decode_iter_ms``,
in the cells that hold no tpot_p90_ms; there it moves j_per_tok."""
from bench.readers import reader

read = reader("decode_iter_ms")
