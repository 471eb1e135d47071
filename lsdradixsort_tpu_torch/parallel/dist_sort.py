"""Distributed sort over a mesh of processes (north star config 5) — the
port of lsdradixsort_tpu/parallel/dist_sort.py, step for step:

  1. every rank sorts its rows locally (stable, with a global source-rank
     tiebreak so equal keys keep input order);
  2. exact global splitter keys are found by a counted multi-probe search
     over the key space (5 rounds of 255 probes a boundary, each round one
     all-reduce of the counts);
  3. ties on a splitter key are split by global stable rank, from the
     all-gathered per-rank equal-key counts, so even all-equal keys (the
     maximum skew) balance exactly;
  4. rows move to their owner rank with one all_to_all_single a stream,
     at exact split sizes (JAX's ragged_all_to_all): the all-gathered
     (D, D) sizes cross to the host once an exchange;
  5. every rank sorts what it received; the shards in rank order are the
     globally sorted, stable result.

Each rank passes its shard and gets its shard back: exactly n/D rows for
any key distribution. Keys are u32/i32/f32 through the order-preserving
codecs (core/keycodec.py). The local sorts go through the port's sort
seam (ops/sort.py `_sort_rows`): the framework merge engine (the tile
sort and merge pass kernels on a CUDA tensor) or, with engine "xla", a
stable torch.sort, which JAX's "xla" (`lax.sort` on a unique tiebreak)
equals; "auto" picks by the tensor's device, as JAX picks by backend.

torch has no uint32 searchsorted, and the collectives refuse uint32: the
searches run on the bias-flipped int32 view (x ^ 0x80000000 keeps the
unsigned order), the probe arithmetic on int64 values in [0, 2^32) (so
JAX's no-overflow arguments hold by construction), the counts cross as
int64 and the streams as int32 bits. JAX's D = 1 bypass of shard_map is
not ported: D = 1 runs the same collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from lsdradixsort_tpu_torch.core import keycodec
from lsdradixsort_tpu_torch.core.profiling import to_host
from lsdradixsort_tpu_torch.ops.sort import _sort_rows
from lsdradixsort_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh,
                                                  _check_member, all_gather,
                                                  psum)

_SIGN = -(1 << 31)      # 0x80000000 as int32 bits


def _local_sort(keys, src, vals, engine: str, tile_log2: int):
    """Per-rank sort as (keys, [src], [vals...]): stable by (key, src)
    when src is given (a unique, position-consistent tiebreak: the global
    source rank), else by the key alone; payloads ride. Without src, a
    sort with payloads is a torch sort: JAX's unstable `lax.sort` there
    leaves the order of equal keys open, and the stable order is one of
    them."""
    if src is not None:
        return _sort_rows(keys, [src], vals, engine, tile_log2)
    return _sort_rows(keys, (), vals, "xla" if vals else engine, tile_log2)


def _bias(x: torch.Tensor) -> torch.Tensor:
    """uint32 x as int32 whose signed order is x's unsigned order."""
    return x.view(torch.int32) ^ _SIGN


def _unbias(b: torch.Tensor) -> torch.Tensor:
    return (b ^ _SIGN).view(torch.uint32)


def _bias64(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the biased int32 of `_bias`."""
    return (v - (1 << 31)).to(torch.int32)


def _positions(start: int, n: int, device) -> torch.Tensor:
    """start, start + 1, ..., start + n - 1 as uint32 (start + n <= 2^32)."""
    if start + n <= 1 << 31:
        return torch.arange(start, start + n, dtype=torch.int32,
                            device=device).view(torch.uint32)
    return _unbias(_bias64(torch.arange(start, start + n, device=device)))


def _ranks(d: int, n: int, device) -> torch.Tensor:
    """The boundary ranks (d - 1,): shard s starts at global rank s*n/d."""
    return torch.arange(1, d, dtype=torch.int64, device=device) * (n // d)


def _splitter_keys(skb: torch.Tensor, ranks: torch.Tensor, mesh: Mesh,
                   fanout: int = 256, rounds: int = 5) -> torch.Tensor:
    """Exact global splitter keys by a counted multi-probe search.

    For each boundary rank R (0-indexed), finds the key of the R-th row of
    the global sorted order: the smallest K with count(key <= K) >= R+1.
    `skb` is this rank's sorted keys, biased (`_bias`). Each round probes
    fanout-1 evenly spaced candidates a boundary (the first at lo, step
    max((hi-lo)//(fanout-1), 1), offsets clamped to the interval) and all
    boundaries' counts ride one all-reduce. The interval shrinks about
    fanout times a round: 2^32 -> 16.8M -> 66K -> 266 -> 11 -> 0, exact
    after 5 rounds. Returns int64 keys in [0, 2^32)."""
    nb = ranks.shape[0]
    if nb == 0:
        return ranks
    f = fanout
    jj = torch.arange(f - 1, dtype=torch.int64, device=ranks.device)[None, :]
    lo = torch.zeros_like(ranks)
    hi = torch.full_like(ranks, 0xFFFFFFFF)
    for _ in range(rounds):
        w = hi - lo
        step = torch.clamp(w // (f - 1), min=1)
        probes = lo[:, None] + torch.minimum(step[:, None] * jj, w[:, None])
        local = torch.searchsorted(skb, _bias64(probes.reshape(-1)),
                                   right=True)
        total = psum(local, mesh).reshape(nb, f - 1)
        geq = total >= (ranks + 1)[:, None]             # monotone in j
        any_ = geq.any(dim=1)
        first = geq.to(torch.int32).argmax(dim=1)       # 0 if none
        pf = probes.gather(1, first[:, None])[:, 0]
        pprev = probes.gather(1, (first - 1).clamp(min=0)[:, None])[:, 0]
        # without a hit, probes[:, -1] < hi (count(<= hi) >= R+1 holds)
        lo, hi = (torch.where(any_, torch.where(first > 0, pprev + 1, lo),
                              probes[:, -1] + 1),
                  torch.where(any_, pf, hi))
    return lo


def _local_send_plan(skb, splitter_keys, ranks, mesh: Mesh):
    """Where this rank's sorted rows go: (input_offsets, send_sizes), both
    (D,) int64, the chunk for rank d at [offsets[d], offsets[d] +
    sizes[d]). Rows equal to a splitter key are split by global stable
    rank: ranks own equal rows in mesh order, so this rank's share below a
    boundary is its residual rank clamped by the all-gathered per-rank
    equal counts."""
    spb = _bias64(splitter_keys)
    less = torch.searchsorted(skb, spb)
    my_eq = torch.searchsorted(skb, spb, right=True) - less
    r_eq = ranks - psum(less, mesh)             # boundary rank among equals
    all_eq = all_gather(my_eq, mesh)            # (D, nb)
    prefix_eq = all_eq[:mesh.rank].sum(dim=0)
    my_before = torch.minimum(r_eq - torch.minimum(r_eq, prefix_eq), my_eq)
    cuts = less + my_before
    bounds = torch.cat([cuts.new_zeros(1), cuts,
                        cuts.new_full((1,), skb.shape[0])])
    return bounds[:-1], bounds[1:] - bounds[:-1]


def _exchange(arrays, input_offsets, send_sizes, mesh: Mesh, out_len: int):
    """Move each rank's per-destination chunks to their owners, received
    in rank order; each output is out_len rows, the received ones first
    (the rest zero). One all_to_all_single a stream at exact sizes."""
    d, me = mesh.size, mesh.rank
    sizes = all_gather(send_sizes, mesh)                    # (src, dst)
    plan = to_host(torch.cat([sizes.reshape(-1), input_offsets])).tolist()
    send = plan[me * d:(me + 1) * d]
    recv = [plan[s * d + me] for s in range(d)]
    offsets = plan[d * d:]
    total_in, total_out = sum(send), sum(recv)
    if total_out > out_len:
        raise ValueError(f"{total_out} rows arrive for {out_len}")
    packed = all(o == sum(send[:i]) for i, o in enumerate(offsets))
    outs = []
    for a in arrays:
        a = a.contiguous()
        bits = a.view(torch.int32) if a.element_size() == 4 else a
        inp = (bits[:total_in] if packed else
               torch.cat([bits[o:o + s] for o, s in zip(offsets, send)]))
        out = bits.new_empty((out_len,) + bits.shape[1:])
        out[total_out:] = 0
        dist.all_to_all_single(out[:total_out], inp, recv, send,
                               group=mesh.group)
        outs.append(out.view(a.dtype))
    return outs


def _dist_sort_shard(keys, values, ranks, mesh: Mesh, n_total: int,
                     stable: bool, src=None, keep_src: bool = False,
                     engine: str = "auto", tile_log2: int = 15):
    n_local = keys.shape[0]
    if stable and src is None:
        src = _positions(mesh.rank * n_local, n_local, keys.device)
    sk, ssrc, svals = _local_sort(keys, src if stable else None, values,
                                  engine, tile_log2)
    skb = _bias(sk)
    spk = _splitter_keys(skb, ranks, mesh)
    input_offsets, send_sizes = _local_send_plan(skb, spk, ranks, mesh)
    del skb
    payload = (sk, *ssrc, *svals)
    received = _exchange(payload, input_offsets, send_sizes, mesh,
                         out_len=n_total // mesh.size)
    del payload, sk, svals
    rk, *rest = received
    sk, ssrc, svals = _local_sort(rk, rest[0] if stable else None,
                                  rest[len(ssrc):], engine, tile_log2)
    return (sk, *ssrc, *svals) if keep_src else (sk, *svals)


def dist_sort(keys: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS,
              descending: bool = False, engine: str = "auto",
              tile_log2: int = 15) -> torch.Tensor:
    """Globally sort keys (u32/i32/f32, ascending or descending): each
    rank passes its shard (equal lengths) and gets its shard of the sorted
    order. Exact and balanced for any distribution. engine: local-sort
    engine ("auto": the merge engine on a CUDA tensor, a stable torch.sort
    on a CPU tensor)."""
    _check_member(mesh)
    n = keys.shape[0] * mesh.size
    code = keycodec.encode(keys, descending)
    (out,) = _dist_sort_shard(code, (), _ranks(mesh.size, n, keys.device),
                              mesh, n, stable=False, engine=engine,
                              tile_log2=tile_log2)
    return keycodec.decode(out, keys.dtype, descending)


def dist_sort_kv(keys: torch.Tensor, values: torch.Tensor, mesh: Mesh,
                 axis: str = DATA_AXIS, descending: bool = False,
                 engine: str = "auto", tile_log2: int = 15):
    """Globally stable key-value sort of each rank's shard. Keys
    u32/i32/f32, ascending or descending. Stability across ranks comes
    from shipping a 32-bit global source rank with each row (n < 2^32)
    and sorting received rows by (key, rank). Returns (keys, values)."""
    _check_member(mesh)
    n = keys.shape[0] * mesh.size
    code = keycodec.encode(keys, descending)
    ok, ov = _dist_sort_shard(code, (values,),
                              _ranks(mesh.size, n, keys.device), mesh, n,
                              stable=True, engine=engine,
                              tile_log2=tile_log2)
    return keycodec.decode(ok, keys.dtype, descending), ov
