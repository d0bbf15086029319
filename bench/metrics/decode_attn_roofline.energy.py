"""decode_attn_roofline.energy: the same reading as ``decode_attn_roofline``,
in the cells that hold no tpot_p90_ms; there it moves j_per_tok."""
from bench.readers import reader

read = reader("decode_attn_roofline")
