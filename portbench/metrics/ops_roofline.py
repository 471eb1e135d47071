"""% of the card's memory roofline that the operator reaches: its least
time (its input bytes read once and its output bytes written once, at
the card's published memory rate) over the device's busy time a call.
It reads the same work whatever kernels implement the operator."""


def read(w):
    if w.trace is None or not w.calls or w.trace.busy_s <= 0 \
            or not w.peak_bytes_per_s:
        return None
    least_s = w.work["least_bytes"] / w.peak_bytes_per_s
    return 100.0 * least_s / (w.trace.busy_s / w.calls)
