"""portbench — the benchmark of the PyTorch/CUDA port (lsdradixsort_tpu_torch).

One command runs one cell once, from the root of a checkout:

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads the port, makes the cell's data on the card from the seed, warms
up with the cell's own shapes, drives the cell's entry in a closed loop
with one caller for the window (each call ends in a device synchronize),
checks the sampled answers against a plain reference and prints one JSON
result line last on stdout.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name in BENCHMARK.json:

  configs/<config>.json      sizes, source, reduced/assumed keys, guarantees
  data/<generator>.py        makes a configuration's data from the seed
  traffic/<traffic>.json     parameters of one traffic mix
  workloads/<cell>.json      the entry and reference a cell drives, its
                             warm-up, sample and limits
  entries/<entry>.py         the port's call the window drives, its rows
                             and least bytes
  reference/<entry>.py       plain torch reference, the control, compare
  metrics/<metric>.py        reader of one metric (a name's last
                             dot-part, else its first _-part, may be
                             left out of the file name)
  kernel_names/<source>.json the kernels of one csrc/ source of the port

Nothing here imports jax or the JAX package; reference/ imports nothing
of the port either.
"""
