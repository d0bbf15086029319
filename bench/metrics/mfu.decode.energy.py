"""mfu.decode.energy: the same reading as ``mfu.decode``,
in the cells that hold no tpot_p90_ms; there it moves j_per_tok."""
from bench.readers import reader

read = reader("mfu.decode")
