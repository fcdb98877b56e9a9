"""The plain model of the card's deterministic scatter (`core/scatter.py`).

On the card `index_add_det_` groups the ids into runs of equal ids (the
grouping kernel, or `torch.sort` and the run-table kernel past
`GROUP_MAX`) and adds each run in index order
(`csrc/segment_add.cu`).  `segment_plan_plain` and `segment_add_plain`
are the plain versions of the two steps; here they are held, bit for
bit, against the CPU's `index_add_` (which adds in index order) on
skewed, uniform, all-colliding and empty id vectors, into 1-D planes, one
column of a plane, 2-D planes and column slices with a row stride past
their width.  `tests/test_torch_cuda.py` holds the kernels against them
on the card.
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.core import scatter


def _ids(kind, rng, n, rows):
    if kind == "skewed":               # a few hot ids among rare ones
        return (rng.zipf(1.4, n) - 1) % rows
    if kind == "all colliding":
        return np.full(n, rows - 1)
    return rng.integers(0, rows, n)


def _case(kind, layout, rows, n, width, seed):
    """(plane, view, idx, src): the scatter's dst is ``view(plane)``; the
    values' magnitudes spread over eight decades, so the float32 sums
    depend on the order of the adds."""
    rng = np.random.default_rng(seed)
    plane, view = {
        "1-D": (torch.zeros(rows), lambda t: t),
        "one column": (torch.zeros(rows, 4), lambda t: t[:, 2]),
        "2-D": (torch.zeros(rows, width), lambda t: t),
        "column slice": (torch.zeros(rows, width + 3),
                         lambda t: t[:, 1:1 + width])}[layout]
    plane.copy_(torch.tensor(rng.normal(size=plane.shape).astype(np.float32)))
    idx = torch.tensor(_ids(kind, rng, n, rows))
    shape = (n,) + tuple(view(plane).shape[1:])
    src = rng.normal(size=shape) * 10.0 ** rng.integers(-4, 5, shape)
    return plane, view, idx, torch.tensor(src.astype(np.float32))


def _check_plan(plan, idx):
    """The plan's layout: the stable grouped order, its runs in ascending
    id order, their starts and lengths, the runs past `LONG_RUN`."""
    ids = idx.to(torch.int32)
    n = ids.numel()
    assert plan.n == n and plan.buf.dtype == torch.int32
    assert plan.buf.numel() == 4 * n + 4
    want = torch.sort(ids, stable=True)
    assert torch.equal(plan.order.long(), want.indices)
    run_ids, starts, lengths, longs = plan.table()
    assert int(plan.buf[-1]) == scatter.LONG_RUN
    assert int(starts[0]) == 0 and int(starts[-1]) == n
    assert bool((lengths > 0).all()) and int(lengths.sum()) == n
    assert torch.equal(run_ids, torch.unique(ids))
    assert torch.equal(torch.repeat_interleave(run_ids, lengths), want.values)
    assert torch.equal(longs, torch.nonzero(lengths > scatter.LONG_RUN)
                       .reshape(-1).to(torch.int32))


@settings(deadline=None, max_examples=80,
          suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(["skewed", "uniform", "all colliding", "empty"]),
       layout=st.sampled_from(["1-D", "one column", "2-D", "column slice"]),
       rows=st.integers(1, 60), n=st.integers(1, 300),
       width=st.sampled_from([1, 2, 3, 5, 9, 17, 32, 33, 40]),
       seed=st.integers(0, 2 ** 32 - 1))
def test_plain_model_equals_index_add(kind, layout, rows, n, width, seed):
    """The grouping and the run-by-run add in index order
    give `index_add_`'s bits; the columns outside a slice stay as they
    were."""
    n = 0 if kind == "empty" else n
    plane, view, idx, src = _case(kind, layout, rows, n, width, seed)
    want = plane.clone()
    view(want).index_add_(0, idx, src)
    plan = scatter.segment_plan_plain(idx)
    _check_plan(plan, idx)
    got = plane.clone()
    out = scatter.segment_add_plain(view(got), src, plan)
    assert out.data_ptr() == view(got).data_ptr()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_plain_plan_marks_the_long_runs(dtype):
    """A hot id of 100 rows among singletons is one run past `LONG_RUN`,
    the only entry of the long list; runs at `LONG_RUN` rows are not."""
    rng = np.random.default_rng(3)
    idx = np.concatenate([np.full(100, 7), np.arange(100, 300),
                          np.full(scatter.LONG_RUN, 9)])
    idx = torch.tensor(idx[rng.permutation(idx.size)], dtype=dtype)
    plan = scatter.segment_plan_plain(idx)
    _check_plan(plan, idx)
    run_ids, _, lengths, longs = plan.table()
    assert run_ids[longs].tolist() == [7] and lengths[longs].tolist() == [100]
    assert lengths[run_ids == 9].tolist() == [scatter.LONG_RUN]


@pytest.mark.parametrize("width", [1, 2, 3, 5, 9, 16, 17, 32, 257, 7168])
def test_plain_add_at_width(width):
    """At each width the add kernel picks its own tile for (1 to 7,168
    columns), a hot id of 40 rows among singletons and pairs adds in
    index order: the plain add gives `index_add_`'s bits."""
    rng = np.random.default_rng(width)
    idx = np.concatenate([np.full(40, 3), np.arange(10, 50),
                          np.arange(20, 30)])
    idx = torch.tensor(idx[rng.permutation(idx.size)])
    plane = torch.tensor(rng.normal(size=(50, width)).astype(np.float32))
    src = rng.normal(size=(idx.numel(), width)) \
        * 10.0 ** rng.integers(-4, 5, (idx.numel(), width))
    src = torch.tensor(src.astype(np.float32))
    want = plane.clone().index_add_(0, idx, src)
    got = scatter.segment_add_plain(plane.clone(), src,
                                    scatter.segment_plan_plain(idx))
    assert torch.equal(got, want), float((got - want).abs().max())


def test_plans_take_at_most_two_vectors():
    """One grouping launch takes a step's row and column ids: a third id
    vector is refused, on any device."""
    a = torch.tensor([3, 1, 3])
    with pytest.raises(ValueError, match="at most 2"):
        scatter.segment_plans(a, a, a)


def test_plans_are_none_off_the_card():
    """On the CPU (and on meta) no plan is made: `index_add_det_` is
    `index_add_` there, which adds in index order."""
    a, b = torch.tensor([3, 1, 3]), torch.tensor([0, 0], dtype=torch.int32)
    assert scatter.segment_plans(a, b) == [None, None]
    assert scatter.segment_plan(a) is None
    assert scatter.segment_plans() == []
    assert scatter.segment_plan(torch.zeros(2, dtype=torch.long,
                                            device="meta")) is None


def test_index_add_det_on_cpu_is_the_plain_model():
    """On the CPU `index_add_det_` (with or without the plans it is given
    by `segment_plans`) equals the plain model on a skewed 2-D case."""
    plane, view, idx, src = _case("skewed", "column slice", 40, 500, 33, 5)
    pi, = scatter.segment_plans(idx)
    got = plane.clone()
    scatter.index_add_det_(view(got), idx, src, plan=pi)
    model = plane.clone()
    scatter.segment_add_plain(view(model), src,
                              scatter.segment_plan_plain(idx))
    assert torch.equal(got, model)
