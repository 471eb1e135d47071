"""Seconds from the start of the process to the start of the window:
import, the kernels' build or load, the data on the device, warm-up."""


def read(w):
    return w.setup_s
