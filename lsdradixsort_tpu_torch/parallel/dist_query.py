"""Distributed query operators: GROUP BY, joins, filter, top-k and
DISTINCT over a mesh of processes — the port of
lsdradixsort_tpu/parallel/dist_query.py (north star config 5,
BASELINE.json: "distributed sort+join query: 1B rows hash-partitioned
across 2+ hosts with skew-aware radix shuffle").

The operators ride the distributed sort (parallel/dist_sort.py), which
solves the hard distributed problems: exact balanced partitioning under
any skew and the exact-size all-to-all. A sorted layout is balanced for
any key distribution, where a hash-partitioned heavy key overloads one
rank, and it is the layout the local sort-based aggregation and join
want. After the global sort a key's rows are contiguous but may span
rank boundaries; each rank's head and tail run summaries (O(D) scalars)
are all-gathered and the ownership chains, including runs that span many
whole ranks (all-equal keys), are resolved by vector math over the
gathered (D,) arrays, as in the JAX package.

Each rank passes its shards and gets its own shard of every output:
`counts` is a (1,) uint32 tensor and the other outputs are valid on
[:count] (rows past it are unspecified). `dist_top_k` returns the
replicated result on every rank. `undistribute` all-gathers the shards
and compacts them into numpy arrays. The valid-first partitions are the
port's stable compaction (ops/filter.py `compact`, the
compact_stream_multi kernel on a CUDA tensor); the cross-rank broadcast
of the join is the fill-forward kernel (kernels/fill_forward.py).
"""
from __future__ import annotations

import numpy as np
import torch

from lsdradixsort_tpu_torch.core import keycodec
from lsdradixsort_tpu_torch.core.convert import (gather, i64_to_u32,
                                                 stable_order, to_numpy,
                                                 u32_to_i64, wrap_u32)
from lsdradixsort_tpu_torch.core.profiling import to_host
from lsdradixsort_tpu_torch.kernels.fill_forward import fill_forward_last
from lsdradixsort_tpu_torch.ops.filter import compact, filter_kv
from lsdradixsort_tpu_torch.ops.join import hash_join_multi
from lsdradixsort_tpu_torch.ops.topk import top_k
from lsdradixsort_tpu_torch.parallel.dist_sort import (_SIGN, _bias,
                                                       _dist_sort_shard,
                                                       _exchange, _positions,
                                                       _ranks, dist_sort_kv)
from lsdradixsort_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh,
                                                  _check_member, all_gather)


def _chain_correction(t_key, h_key, h_sum, full, me: int, d: int):
    """Sum of following ranks' head-run sums that continue my tail run:
    rank j > me contributes h_sum[j] if h_key[j] == my tail key and every
    rank strictly between me and j is entirely that key."""
    j = torch.arange(d, device=h_key.device)
    same = h_key == t_key
    blocker = ((j > me) & ~(full & same)).to(torch.int64)
    blocked_before = torch.cumsum(blocker, 0) - blocker  # blockers in (me, j)
    take = (j > me) & same & (blocked_before == 0)
    return torch.where(take, h_sum, 0).sum()


def _dist_group_by_sum_shard(keys, vals, ranks, mesh: Mesh, n_total: int):
    sk, sv = _dist_sort_shard(keys, (vals,), ranks, mesh, n_total,
                              stable=False)
    n_local = sk.shape[0]
    me, d = mesh.rank, mesh.size
    dev = sk.device
    skw = sk.view(torch.int32)          # keys compared for equality only
    # run structure within the shard; sums mod 2^32 as int64 running sums
    csum = torch.cumsum(u32_to_i64(sv), 0)
    head_key, tail_key = skw[0], skw[-1]
    in_head = skw == head_key
    head_len = in_head.sum()
    head_sum = csum[head_len - 1] & 0xFFFFFFFF
    g = all_gather(torch.stack([head_key.to(torch.int64),
                                tail_key.to(torch.int64), head_sum]), mesh)
    h_key, t_key, h_sum = g.unbind(1)                    # (D,) each
    full = h_key == t_key                                # single-key ranks
    own_head = (t_key[me - 1] != h_key[me] if me > 0
                else torch.ones((), dtype=torch.bool, device=dev))
    corr = _chain_correction(t_key[me], h_key, h_sum, full, me, d)

    # local per-run sums at the run ends; a head run that an earlier rank
    # owns is dropped
    is_last = torch.cat([skw[1:] != skw[:-1],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    valid = is_last & ~(~own_head & in_head)
    pos = torch.arange(n_local, dtype=torch.int32, device=dev)
    count, vk, vpos = compact(valid, sk, pos)            # valid first
    k = torch.arange(n_local, device=dev)
    in_range = k < u32_to_i64(count)
    vpos = torch.where(in_range, vpos.to(torch.int64), 0)
    vcs = csum[vpos]
    # run sum = csum[last] - csum[the previous run's last]; the first
    # valid run starts after the dropped head run, or at 0
    prev_last = torch.cat([vpos.new_zeros(1), vpos[:-1] + 1])
    first_start = torch.where(own_head, 0, head_len)
    run_start = torch.where(k == 0, first_start, prev_last)
    sums = torch.where(run_start > 0,
                       vcs - csum[run_start.clamp(min=1) - 1], vcs)
    # the cross-rank continuation goes to my tail run, if I own it
    is_my_tail = (vk.view(torch.int32) == tail_key) & in_range
    sums = torch.where(is_my_tail, sums + corr, sums)
    return count.reshape(1), vk, wrap_u32(sums)


def dist_group_by_sum(keys: torch.Tensor, values: torch.Tensor, mesh: Mesh,
                      axis: str = DATA_AXIS):
    """Distributed GROUP BY key SUM(value) (modular uint32 sums) of each
    rank's shard of uint32 keys and values. Returns (counts, keys, sums):
    this rank's groups on [:counts[0]], keys globally sorted across the
    ranks' valid rows."""
    _check_member(mesh)
    n = keys.shape[0] * mesh.size
    return _dist_group_by_sum_shard(keys, values,
                                    _ranks(mesh.size, n, keys.device),
                                    mesh, n)


def _dist_join_shard(keys, val, src, ranks, mesh: Mesh, n_total: int):
    """Local step of the distributed join after a stable global sort by
    key. `src` packs (tag, global row position), bit 31 set on probe rows:
    it is both the stability rank (build rows sort before the probe rows
    of their key) and the carrier of the probe position, so the exchange
    ships 3 streams (key, src, val). After the re-sort by (key, src) a
    key's build row, unique by contract, is the first row of its key's run
    in whichever rank it landed in; that can be any rank of the key's
    span, so the build value propagates both forward and backward across
    chains of ranks that hold only that key."""
    sk, ssrc, sval = _dist_sort_shard(keys, (val,), ranks, mesh, n_total,
                                      stable=True, src=src, keep_src=True)
    is_build = ssrc.view(torch.int32) >= 0
    me, d = mesh.rank, mesh.size
    skw = sk.view(torch.int32)
    # within-rank broadcast of each build row's value to its key's probe
    # rows (build keys unique; build rows sort before their probes)
    bk_fill, seg_bval, has_build = fill_forward_last(is_build, sk, sval)
    seg_hit = ((has_build.view(torch.int32) == 1)
               & (bk_fill.view(torch.int32) == skw))
    seg_bval = seg_bval.view(torch.int32)
    head_key, tail_key = skw[0], skw[-1]
    # the head run's build row sits at position 0 when present
    g = all_gather(torch.stack([head_key, tail_key, seg_bval[-1],
                                seg_hit[-1].to(torch.int32),
                                is_build[0].to(torch.int32),
                                sval.view(torch.int32)[0]]), mesh)
    h_key, t_key, t_bval, t_hit, f_isb, f_bval = g.unbind(1)
    full = h_key == t_key
    j = torch.arange(d, device=sk.device)

    # FORWARD: nearest rank j < me with tail key == my head key, a build
    # row seen in its tail run, and every rank in (j, me) only that key
    same_f = t_key == head_key
    blk = ((j < me) & ~(full & same_f)).to(torch.int64)
    blocked_fwd = torch.flip(torch.cumsum(torch.flip(blk, [0]), 0), [0]) - blk
    cand_f = (j < me) & same_f & (blocked_fwd == 0) & (t_hit == 1)
    best_f = torch.where(cand_f, j, -1).max()
    fwd_hit = best_f >= 0
    fwd_bval = torch.where(fwd_hit, t_bval[best_f.clamp(min=0)], 0)
    in_head_run = skw == head_key
    seg_bval = torch.where(in_head_run & ~seg_hit & fwd_hit, fwd_bval,
                           seg_bval)
    seg_hit = seg_hit | (in_head_run & fwd_hit)

    # BACKWARD: nearest rank j > me whose head key == my tail key with the
    # build row at its head, and a chain of single-key ranks in (me, j)
    same_b = h_key == tail_key
    blk_b = ((j > me) & ~(full & same_b)).to(torch.int64)
    blocked_bwd = torch.cumsum(blk_b, 0) - blk_b
    cand_b = (j > me) & same_b & (blocked_bwd == 0) & (f_isb == 1)
    best_b = torch.where(cand_b, j, d).min()
    bwd_hit = best_b < d
    bwd_bval = torch.where(bwd_hit, f_bval[best_b.clamp(max=d - 1)], 0)
    in_tail_run = skw == tail_key
    seg_bval = torch.where(in_tail_run & ~seg_hit & bwd_hit, bwd_bval,
                           seg_bval)
    seg_hit = seg_hit | (in_tail_run & bwd_hit)

    matched = ~is_build & seg_hit
    ppos = (ssrc.view(torch.int32) & ~_SIGN).view(torch.uint32)
    count, *cols = compact(matched, sk, sval, seg_bval.view(torch.uint32),
                           ppos)                         # matches first
    return (count.reshape(1), *cols)


def dist_join(build_keys: torch.Tensor, build_vals: torch.Tensor,
              probe_keys: torch.Tensor, probe_vals: torch.Tensor, mesh: Mesh,
              axis: str = DATA_AXIS):
    """Distributed inner equi-join (unique build keys) of each rank's
    build and probe shards (uint32). Returns (counts, keys, probe_vals,
    build_vals, probe_pos), this rank's matches on [:counts[0]];
    `undistribute` and a sort by probe_pos give the single-chip order."""
    _check_member(mesh)
    me, d = mesh.rank, mesh.size
    nbl, npl = build_keys.shape[0], probe_keys.shape[0]
    n = (nbl + npl) * d
    dev = build_keys.device
    # rank s holds build shard s, then probe shard s; the tagged src ranks
    # every build row below every probe row of its key
    keys = torch.cat([build_keys, probe_keys])
    val = torch.cat([build_vals, probe_vals])
    gprobe = _positions(me * npl, npl, dev).view(torch.int32) | _SIGN
    src = torch.cat([_positions(me * nbl, nbl, dev),
                     gprobe.view(torch.uint32)])
    return _dist_join_shard(keys, val, src, _ranks(d, n, dev), mesh, n)


def undistribute(counts, *arrays, mesh: Mesh):
    """Every rank's ragged outputs, compacted: (total, *numpy arrays), the
    valid rows of rank 0, then rank 1, .... Each rank passes its own
    counts (1,) and equal-length shards; every rank gets the result."""
    _check_member(mesh)
    c = to_host(all_gather(u32_to_i64(counts.reshape(1)), mesh)
                ).reshape(-1).tolist()
    outs = []
    for a in arrays:
        g = to_numpy(all_gather(a, mesh).reshape(-1)).reshape(mesh.size, -1)
        outs.append(np.concatenate([g[s, :c[s]] for s in range(mesh.size)]))
    return (sum(c), *outs)


def dist_filter_kv(keys: torch.Tensor, values: torch.Tensor, lo, hi,
                   mesh: Mesh, axis: str = DATA_AXIS):
    """Distributed range filter lo <= key < hi: a rank-local stable
    compaction. Returns (counts, keys, values), this rank's rows on
    [:counts[0]], order kept within and across ranks."""
    _check_member(mesh)
    count, fk, fv = filter_kv(keys, values, lo, hi)
    return count.reshape(1), fk, fv


def _dist_join_multi_shard(sbk, sbv, pk, pv, mesh: Mesh, max_out: int):
    """Fragment join on one rank: its sorted build fragment x every probe
    whose key falls in the fragment's key range. Build rows are spread
    exactly evenly by the distributed sort, so a heavy key's B x P
    product is P x (B/D) rows a rank: all-equal keys balance exactly."""
    npl, nbl = pk.shape[0], sbk.shape[0]
    me, d = mesh.rank, mesh.size
    dev = pk.device
    # every rank's build key range, in rank (= global sorted) order
    los, his = all_gather(torch.stack([sbk[0], sbk[-1]]), mesh).unbind(1)
    # local probes sorted by key: each destination's probes are one slice
    # [searchsorted(lo), searchsorted(hi)); slices of adjacent ranks
    # overlap when a build run spans them, which is the replication the
    # exchange must make
    perm = stable_order([pk])
    spk = gather(pk, perm)
    sppos = gather(_positions(me * npl, npl, dev), perm)
    spv = gather(pv, perm)
    del perm
    spkb = _bias(spk)
    starts = torch.searchsorted(spkb, _bias(los.contiguous()))
    ends = torch.searchsorted(spkb, _bias(his.contiguous()), right=True)
    del spkb
    send_sizes = ends - starts
    out_len = npl * d                                   # worst case: all
    rpk, rppos, rpv = _exchange((spk, sppos, spv), starts, send_sizes, mesh,
                                out_len)
    del spk, sppos, spv
    m = all_gather(send_sizes, mesh)[:, me].sum()
    valid = torch.arange(out_len, device=dev) < m
    count, jk, (jpv, jppos), jbv, bidx = hash_join_multi(
        sbk, sbv, rpk, (rpv, rppos), max_out=max_out, probe_valid=valid,
        return_build_idx=True)
    # global stable build rank: fragments are globally sorted and exactly
    # balanced, so rank = me * (nb/D) + local index
    brank = i64_to_u32(u32_to_i64(bidx) + me * nbl)
    return (count.reshape(1), jk, jppos, jpv, jbv, brank)


def dist_join_multi(build_keys: torch.Tensor, build_vals: torch.Tensor,
                    probe_keys: torch.Tensor, probe_vals: torch.Tensor,
                    mesh: Mesh, max_out: int, axis: str = DATA_AXIS):
    """Distributed many-to-many inner equi-join (duplicate build keys).

    The build side is distributed-sorted (balanced under any skew), each
    rank owns one contiguous fragment of the global build order, and
    every probe is routed, with replication, to each rank whose fragment
    key range holds its key; each rank joins its fragment against the
    probes it received (ops/join.py `hash_join_multi`).

    Returns (counts, keys, probe_pos, probe_vals, build_vals, build_rank),
    this rank's rows on [:counts[0]] (each output max_out long); sorting
    all ranks' rows by (probe_pos, build_rank) gives the single-chip
    order. counts are untruncated, so a caller sees max_out overflow.
    Each rank's receive buffer holds npl * D probe rows (the worst-case
    replication)."""
    _check_member(mesh)
    sbk, sbv = dist_sort_kv(build_keys, build_vals, mesh)
    return _dist_join_multi_shard(sbk, sbv, probe_keys, probe_vals, mesh,
                                  max_out)


def dist_top_k(keys: torch.Tensor, k: int, mesh: Mesh, largest: bool = True,
               axis: str = DATA_AXIS):
    """Distributed ORDER BY ... LIMIT k: every global top-k row is in its
    rank's local top-k, so one local top_k a rank (ops/topk.py), an
    all-gather of the D*k candidate (value, global index) pairs and one
    small sort finish it. Requires k <= rows a rank. Returns (values,
    global_indices), both length k, on every rank; ties broken by global
    position, as the single-chip top_k."""
    _check_member(mesh)
    nl = keys.shape[0]
    if k > nl:
        raise ValueError(f"k={k} must be <= rows per shard ({nl})")
    lv, li = top_k(keys, k, largest=largest)
    gi = i64_to_u32(u32_to_i64(li) + mesh.rank * nl)
    av = all_gather(lv, mesh).reshape(-1)               # (D*k,)
    ai = all_gather(gi, mesh).reshape(-1)
    codes = keycodec.encode(av, descending=largest)
    # candidates arrive rank-major with ascending global indices within a
    # rank, so a stable sort of the codes alone is the global stable order
    perm = stable_order([codes])[:k]
    return (keycodec.decode(gather(codes, perm), keys.dtype,
                            descending=largest), gather(ai, perm))


def dist_unique(keys: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS):
    """Distributed SELECT DISTINCT with counts: sorted distinct keys with
    their multiplicities, ragged a rank as every dist operator. One
    distributed group-by of unit values."""
    ones = torch.ones(keys.shape[0], dtype=torch.int32, device=keys.device)
    return dist_group_by_sum(keys, ones.view(torch.uint32), mesh=mesh)
