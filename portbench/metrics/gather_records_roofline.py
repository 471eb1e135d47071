"""% of the memory roofline that the gather of whole records reaches
(kernel_names function `gather_records`): each launch, handed the call's
rows, reads each row's u32 permutation entry and source record once and
writes its output record once, rows x (2 x record_bytes + 4) bytes, over
the kernel's device time. Nothing where the entry moves no records or the
trace holds no launch."""


def read(w):
    spec = w.kernel_names.get("functions", {}).get("gather_records")
    width = w.work.get("record_bytes")
    if w.trace is None or spec is None or not width \
            or not w.peak_bytes_per_s:
        return None
    launches, _ = w.trace.matching([spec["launch"]])
    _, secs = w.trace.matching(spec["kernels"])
    if launches == 0 or secs <= 0:
        return None
    moved = launches * w.work["rows"] * (2 * width + 4)
    return 100.0 * moved / w.peak_bytes_per_s / secs
