"""j_per_tok: the card's energy over the window over the tokens that tok_s
counts."""


def read(rec):
    if rec.joules is None or not rec.tokens:
        return None
    return rec.joules / rec.tokens
