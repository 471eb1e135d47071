"""% of the memory roofline that the merge passes reach (kernel_names
function `merge_pass`: merge_tiles with its partition, coarse_splits and
merge_splits): every stream of the rows a pass is handed read once and
written once, over its kernels' device time."""


def read(w):
    return w.function_roofline("merge_pass")
