"""The 95th percentile of all the window's calls' latency in ms, each
call timed on the host's clock from its start to the end of the device
synchronize that follows it."""


def read(w):
    return 1e3 * w.percentile(95)
