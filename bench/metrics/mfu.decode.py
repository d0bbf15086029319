"""mfu.decode: the model FLOPs of the window's decode steps (the
reference's ``decode_flops`` over the rows each step served) over their
seconds, as a share of the card's bf16 peak."""
from bench.roofline import PEAK_BF16_FLOPS


def read(rec):
    its = rec.of("decode")
    if not its:
        return None
    flops = sum(rec.ref.decode_flops(rec.cfg, i.keys) for i in its)
    return 100.0 * flops / sum(i.t1 - i.t0 for i in its) / PEAK_BF16_FLOPS
