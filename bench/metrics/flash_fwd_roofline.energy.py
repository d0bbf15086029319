"""flash_fwd_roofline.energy: the same reading as ``flash_fwd_roofline``,
in the cells that hold no ttft_p90_ms; there it moves j_per_tok."""
from bench.readers import reader

read = reader("flash_fwd_roofline")
