"""tok_s: every token of the window's iterations (each prefill's prompt
tokens and its first token, each decode step's served rows) over the
window's seconds."""


def read(rec):
    return rec.tokens / rec.seconds if rec.iterations else None
