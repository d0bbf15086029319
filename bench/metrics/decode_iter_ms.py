"""decode_iter_ms: the window's decode seconds over its decode iterations."""


def read(rec):
    its = rec.of("decode")
    return sum(i.t1 - i.t0 for i in its) * 1e3 / len(its) if its else None
