"""power_w: the card's energy over the window over its seconds."""


def read(rec):
    return None if rec.joules is None else rec.joules / rec.seconds
