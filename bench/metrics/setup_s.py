"""setup_s: from the process's start to the window's opening."""


def read(rec):
    return rec.setup_s
