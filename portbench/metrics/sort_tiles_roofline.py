"""% of the memory roofline that the tile sort reaches (kernel_names
function `sort_tiles`: cluster_sort, bitonic_stage): every stream of the
rows a launch is handed read once and written once, over its kernels'
device time."""


def read(w):
    return w.function_roofline("sort_tiles")
