"""Device ms a call in operations that are none of the port's own
kernels (kernel_names): library sorts, gathers, conversions, copies;
0 where the device ran nothing but the port's kernels."""


def read(w):
    if w.trace is None or not w.calls or not w.trace.device:
        return None
    _, own_s = w.trace.matching(w.kernel_names.get("kernels", []))
    glue_s = sum(e.end - e.start for e in w.trace.device) / 1e9 - own_s
    return 1e3 * max(glue_s, 0.0) / w.calls
