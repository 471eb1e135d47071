"""The one-word cluster tile sort at E = 32 and E = 64 rows a thread, on
one card.

    python -m lsdradixsort_tpu_torch.bench.tile_geometry [--out FILE]

`kernels/tile_sort.py` GEOMETRY sorts keys alone with E = 64 rows a
thread (G = 6), the only one-word instance csrc/tile_sort.cu builds. This
script builds that source alone into a library of its own with the E = 32
(G = 5) instance added (two edits made in memory; it stops if the source
no longer holds them), checks both against the plain version at 2^27 keys
and the 2^15-row tile, and times through the library's lsd_sort_tiles:

- the whole schedule at each E;
- partial schedules that isolate a step's cost: the FIRST step (load and
  phases 1..G) with the last step (the stages below G of phase 15 and the
  store) alone; the same with ten G-stage register steps between; and with
  ten 1-stage steps between. (Their outputs are not sorted.)

Each time is the median of 5 CUDA-event timings after a warm-up. Prints
one line an E; --out writes them as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

# the E = 32 one-word instance: built geometry, then the launch switch
EDITS = (("(W == 1 && G == 6)", "(W == 1 && (G == 5 || G == 6))"),
         ("    LSD_CASE(1, 6)\n", "    LSD_CASE(1, 5)\n    LSD_CASE(1, 6)\n"))
TILE_LOG2 = 15


def side_library() -> Path:
    """csrc/tile_sort.cu with EDITS, built alone into build/tile_geometry/."""
    from lsdradixsort_tpu_torch.kernels import _build
    src = (_build.CSRC / "tile_sort.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/tile_sort.cu no longer holds {old!r} "
                               f"once: update EDITS")
        src = src.replace(old, new)
    out = _build.BUILD_DIR.parent / "tile_geometry"
    out.mkdir(parents=True, exist_ok=True)
    (out / "tile_sort.cu").write_text(src)
    lib = out / "tile_sort.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(out / "tile_sort.cu")],
                          capture_output=True, text=True, check=False)
    (out / "tile_sort.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exit {proc.returncode}:\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("tile_geometry: no CUDA device", file=sys.stderr)
        return 1
    from lsdradixsort_tpu_torch.bench.flagship import check_keys
    from lsdradixsort_tpu_torch.core.datagen import random_keys
    from lsdradixsort_tpu_torch.core.timing import card_label, time_fn
    from lsdradixsort_tpu_torch.kernels import _build
    from lsdradixsort_tpu_torch.kernels import tile_sort as TS

    dev = torch.device("cuda")
    card = card_label()
    lib = ctypes.CDLL(str(side_library()))
    sort = lib.lsd_sort_tiles
    sort.argtypes = TS.SORT_ARGTYPES
    sort.restype = ctypes.c_int
    n = 1 << 27
    keys = random_keys(n, 0, dev)
    want = TS.sort_tiles_plain(keys, (1 << TILE_LOG2) // TS.LANES)
    S = TS.Step
    res = {}
    for g in (5, 6):
        def run(steps, g=g):
            code = (ctypes.c_int * len(steps))(*[s.code for s in steps])
            dst = torch.empty_like(keys)
            err = sort(_build.pointers([keys]), _build.pointers([dst]), 1, n,
                       TILE_LOG2, 0, 1, TILE_LOG2, g, code, len(code), None,
                       None, 0, ctypes.c_void_p(
                           torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"lsd_sort_tiles G={g}: CUDA error {err}")
            return dst

        full = TS._schedule(TILE_LOG2, TILE_LOG2, TILE_LOG2, g)
        check_keys(run(full), want, f"sort_tiles E={1 << g}")
        top = TILE_LOG2 - g
        first = S(TS.FIRST, g)
        last = S(TS.GROUP, TILE_LOG2, -1, g - 1, 0, 0)
        wide = S(TS.GROUP, TILE_LOG2, -1, TILE_LOG2 - 1, top, top)
        thin = S(TS.GROUP, TILE_LOG2, -1, top, top, top)
        probes = {"full": full, "first+last": [first, last],
                  f"+10 {g}-stage steps": [first] + [wide] * 10 + [last],
                  "+10 1-stage steps": [first] + [thin] * 10 + [last]}
        res[f"E={1 << g}"] = {
            "steps": len(full),
            **{k: time_fn(run, v, iters=5).ms for k, v in probes.items()}}
        print(f"sort_tiles one word, E={1 << g} ({len(full)} steps), 2^27 "
              f"keys, 2^15-row tile: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in
                          res[f"E={1 << g}"].items() if k != "steps")
              + f" ({card})")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, **res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
