"""prefill_ms_per_ktok: the window's prefill iterations' seconds over their
prompt tokens, per thousand tokens."""


def read(rec):
    its = rec.of("prefill")
    if not its:
        return None
    return sum(i.t1 - i.t0 for i in its) * 1e3 / (sum(i.prompt for i in its) / 1e3)
