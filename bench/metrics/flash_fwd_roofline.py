"""flash_fwd_roofline: in the profiled slice, the flash forward's least
times (``roofline.flash_fwd_s`` for each prefill and layer) over the device
time of ``flash_fwd_wgmma_kernel``."""


def read(rec):
    s = rec.slice
    if s is None or not s["prefills"] or not s["flash_s"]:
        return None
    return 100.0 * s["flash_bound_s"] / s["flash_s"]
