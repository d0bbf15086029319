"""device_idle.energy: the same reading as ``device_idle``,
in the cells that hold no tok_s; there it moves j_per_tok."""
from bench.readers import reader

read = reader("device_idle")
