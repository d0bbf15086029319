"""mfu.prefill: the model FLOPs of the window's prefills (the reference's
``prefill_flops``: the active weights each token passes, its attention, the
output head once) over their seconds, as a share of the card's bf16 peak."""
from bench.roofline import PEAK_BF16_FLOPS


def read(rec):
    its = rec.of("prefill")
    if not its:
        return None
    flops = sum(rec.ref.prefill_flops(rec.cfg, i.prompt) for i in its)
    return 100.0 * flops / sum(i.t1 - i.t0 for i in its) / PEAK_BF16_FLOPS
