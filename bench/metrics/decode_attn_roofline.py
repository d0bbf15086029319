"""decode_attn_roofline: in the profiled slice, decode attention's least
times (``roofline.decode_attn_s``: K and V up to each row's valid slots)
over the device time of ``decode_mma_kernel``."""


def read(rec):
    s = rec.slice
    if s is None or not s["decodes"] or not s["decode_s"]:
        return None
    return 100.0 * s["decode_bound_s"] / s["decode_s"]
