"""The port's spans and counters (core/profiling.py): `annotate` costs no
`record_function` while no profiler runs; under the CPU profiler the op
and stage spans of a sort, a merge join, a filtered GROUP BY and a sort
of records nest as the calls do, with no kernel spans on the plain path;
the host-sync, int64 and record counters count what the calls do;
outputs do not change."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lsdradixsort_tpu_torch as lsd
from lsdradixsort_tpu_torch.core import profiling

N = 1 << 15             # one tile of the framework sort


def _u32(n, hi, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, hi, (n,), generator=g, dtype=torch.int64
                         ).to(torch.int32).view(torch.uint32)


def _records(n, seed):
    """n records of 100 bytes, random bytes from the seed."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 100), generator=g, dtype=torch.uint8)


CALLS = {
    "sort": lambda: lsd.sort(_u32(N, 1 << 31, 1), strategy="merge"),
    # 4000 rows, a short tile: no padding, so no sentinel check to read
    "join": lambda: lsd.hash_join(_u32(1000, 5000, 2), _u32(1000, 1 << 31, 3),
                                  _u32(3000, 5000, 4), _u32(3000, 1 << 31, 5),
                                  engine="merge"),
    "agg": lambda: lsd.filtered_group_by_sum(
        _u32(N, 100, 6), _u32(N, 4, 7), _u32(N, 1 << 31, 8), 0, 80,
        engine="merge"),
    # 10-byte keys: three key words, a merge sort each
    "records": lambda: lsd.sort_records(_records(3000, 9), 10),
}

# (depth, span) in the order the spans open
TREES = {
    "sort": [(0, "lsd.sort"), (1, "lsd.merge_sort")],
    "join": [(0, "lsd.hash_join"), (1, "lsd.join.tag"),
             (1, "lsd.merge_sort"), (1, "lsd.join.match"),
             (1, "lsd.join.probe_order"), (1, "lsd.join.gather")],
    "agg": [(0, "lsd.filtered_group_by_sum"), (1, "lsd.agg.mask"),
            (1, "lsd.merge_sort"), (1, "lsd.agg.runs")],
    "records": [(0, "lsd.sort_records"), (1, "lsd.records.keys"),
                (1, "lsd.records.sort"), (2, "lsd.merge_sort"),
                (2, "lsd.merge_sort"), (2, "lsd.merge_sort"),
                (1, "lsd.records.gather")],
}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("lsd.")),
                   key=lambda e: (e.start_ns(), -e.end_ns()))
    tree, stack = [], []
    for e in spans:
        while stack and stack[-1] <= e.start_ns():
            stack.pop()
        tree.append((len(stack), e.name()))
        stack.append(e.end_ns())
    return out, tree


def _counted(fn):
    before = profiling.counts()
    fn()
    after = profiling.counts()
    return {k: after[k] - before[k] for k in after}


def test_annotate_without_a_profiler_enters_no_record_function(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    span = profiling.annotate("lsd.sort")
    assert span is profiling._OFF
    assert profiling.annotate("lsd.other") is span
    with span, span:
        pass
    assert profiling.host_value(torch.tensor(3)) == 3


def test_annotate_under_a_profiler_is_a_record_function(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: seen.append(name) or profiling._OFF)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.annotate("lsd.sort")
    assert seen == ["lsd.sort"]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_spans_nest_as_the_calls_do(call):
    _, tree = _profiled(CALLS[call])
    assert tree == TREES[call]
    assert not any(name.startswith("lsd.kernel.") for _, name in tree)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_outputs_are_the_same_with_the_profiler_on_and_off(call):
    off = CALLS[call]()
    on, _ = _profiled(CALLS[call])
    flat_off, flat_on = (torch.utils._pytree.tree_flatten(o)[0]
                         for o in (off, on))
    assert len(flat_off) == len(flat_on)
    for a, b in zip(flat_off, flat_on):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_host_syncs_count_the_values_read():
    assert _counted(CALLS["sort"])["host_syncs"] == 0
    assert _counted(CALLS["join"])["host_syncs"] == 0   # no sentinel check
    assert _counted(CALLS["agg"])["host_syncs"] == 0


@pytest.mark.parametrize("call,want", [("sort", 0), ("agg", 0), ("join", 1),
                                       ("records", 3)])
def test_ragged_sorts_count_the_sorts_of_a_short_tile(call, want):
    # N = 2^15 rows are one whole tile; the join's 4000 rows and each of
    # the records' three key-word sorts of 3000 rows are not
    assert _counted(CALLS[call])["ragged_sorts"] == want


def test_record_bytes_count_the_rows_gathered():
    # a sort of 3000 records of 100 bytes moves each once; the others
    # move none
    assert _counted(CALLS["records"])["record_bytes"] == 3000 * 100
    assert _counted(CALLS["records"])["host_syncs"] == 0
    for call in ("sort", "join", "agg"):
        assert _counted(CALLS[call])["record_bytes"] == 0


def test_int64_bytes_count_the_widenings():
    # the plain versions widen seven columns of N rows: the range mask's
    # keys, the running sum's scan and rows, the run ends' sums, the
    # scan's rows and the tile sort's order key of (key, packed); on the
    # card only the range mask's keys (the reduction after the sort is
    # one kernel, kernels/aggregate.py)
    got = _counted(CALLS["agg"])["int64_bytes"]
    assert got == 8 * (4 * N + N + 2 * N)
    # a one-tile keys sort widens its keys once, in the plain tile sort
    assert _counted(CALLS["sort"])["int64_bytes"] == 8 * N
