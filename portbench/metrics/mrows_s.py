"""Millions of rows the calls of the window read, over the window's
seconds on the host's clock (closed loop, one caller)."""


def read(w):
    return w.rows / w.seconds / 1e6
