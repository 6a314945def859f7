"""The port's trees and plan tables against the JAX package's.

``repro_torch.core.treegather.build_gather_tree`` and
``repro_torch.core.torch_collectives.plan_gatherv`` must give, element for
element, the edge lists and step tables of ``repro.core``'s.  Plans are
host-side integer tables, so the tolerance is exact equality.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.distributions import NAMES, block_sizes  # noqa: E402
from repro.core.jax_collectives import _reversed_step_tables as jax_reversed  # noqa: E402
from repro.core.jax_collectives import plan_gatherv as jax_plan_gatherv  # noqa: E402
from repro.core.treegather import build_gather_tree as jax_build_tree  # noqa: E402

from repro_torch.core import carry  # noqa: E402
from repro_torch.core.distributions import NAMES as T_NAMES  # noqa: E402
from repro_torch.core.distributions import block_sizes as t_block_sizes  # noqa: E402
from repro_torch.core.torch_collectives import _reversed_step_tables, plan_gatherv  # noqa: E402
from repro_torch.core.treegather import build_gather_tree  # noqa: E402

PS = (1, 2, 3, 5, 8, 16, 64)
POLICIES = ((1, 0.0), (3, 0.0), (1, 2.0))


def _roots(p):
    return sorted({0, p // 2, p - 1})


def assert_steps_equal(a, b):
    assert len(a) == len(b)
    for (pa, la, sa, ra, va), (pb, lb, sb, rb, vb) in zip(a, b):
        assert tuple(map(tuple, pa)) == tuple(map(tuple, pb))
        assert int(la) == int(lb)
        for x, y in ((sa, sb), (ra, rb), (va, vb)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype == np.int32


def assert_plans_equal(tp, jp):
    for f in ("p", "root", "sizes", "offsets", "total", "cap", "buf_rows",
              "tree_bytes_exact", "tree_bytes_padded", "segments",
              "stage_ids", "num_stages", "wave_bin_ratio"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.padding_overhead == jp.padding_overhead
    assert_steps_equal(tp.steps, jp.steps)


def test_distributions_match():
    assert T_NAMES == NAMES
    for name in NAMES:
        for p in PS:
            assert t_block_sizes(name, p, 9, seed=3) == block_sizes(
                name, p, 9, seed=3)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_tree_and_plan_tables_match_reference(name, p):
    sizes = block_sizes(name, p, 7, seed=p)
    for root in (None, *_roots(p)):
        t = build_gather_tree(list(sizes), root=root)
        j = jax_build_tree(list(sizes), root=root)
        assert [dataclasses.astuple(e) for e in t.edges] == \
            [dataclasses.astuple(e) for e in j.edges]
        assert [dataclasses.astuple(m) for m in t.merge_trace] == \
            [dataclasses.astuple(m) for m in j.merge_trace]
        assert (t.root, t.contiguous, t.name) == (j.root, j.contiguous, j.name)
    for root in _roots(p):
        for segments in (1, 2, 4):
            for bucket_rounds, ratio in POLICIES:
                kw = dict(bucket_rounds=bucket_rounds, segments=segments,
                          wave_bin_ratio=ratio)
                assert_plans_equal(plan_gatherv(sizes, root, **kw),
                                   jax_plan_gatherv(sizes, root, **kw))


@pytest.mark.parametrize("name", NAMES)
def test_reversed_step_tables_match_reference(name):
    sizes = block_sizes(name, 16, 11, seed=4)
    for root in (0, 7, 15):
        for segments in (1, 4):
            assert_steps_equal(
                _reversed_step_tables(plan_gatherv(sizes, root,
                                                   bucket_rounds=3,
                                                   segments=segments)),
                jax_reversed(jax_plan_gatherv(sizes, root, bucket_rounds=3,
                                              segments=segments)))


def test_both_split_policies_raise():
    sizes = block_sizes("spikes", 8, 20, seed=1)
    with pytest.raises(ValueError):
        plan_gatherv(sizes, 0, bucket_rounds=3, wave_bin_ratio=2.0)
    with pytest.raises(ValueError):
        jax_plan_gatherv(sizes, 0, bucket_rounds=3, wave_bin_ratio=2.0)


def test_non_contiguous_tree_raises():
    sizes = [1, 1, 30, 30]
    tree = build_gather_tree(sizes, root=0, degrade_threshold=10)
    assert not tree.contiguous
    with pytest.raises(ValueError):
        plan_gatherv(sizes, 0, tree=tree)


@pytest.mark.parametrize("name", NAMES)
def test_carry_round_trip_keeps_tables(name):
    sizes = block_sizes(name, 16, 13, seed=2)
    jp = jax_plan_gatherv(sizes, 5, segments=2, wave_bin_ratio=2.0)
    tp = carry.plan_from_numpy(dataclasses.asdict(jp))
    assert_plans_equal(tp, jp)
    assert_plans_equal(carry.plan_from_numpy(carry.plan_to_numpy(tp)), jp)
    tabs = carry.plan_tensors(tp, "cpu")
    for k, (perm, payload, ss, rs, rv) in enumerate(tp.steps):
        assert tabs.gather.perms[k] == perm and tabs.gather.payloads[k] == payload
        np.testing.assert_array_equal(tabs.gather.send_start[k].numpy(), ss)
        np.testing.assert_array_equal(tabs.gather.recv_start[k].numpy(), rs)
        np.testing.assert_array_equal(tabs.gather.recv_valid[k].numpy(), rv)
        assert tabs.gather.recv_dst[k].tolist() == [d for _, d in perm]
        assert tabs.gather.recv_src[k].tolist() == [s for s, _ in perm]
    one = carry.plan_tensors(tp, "cpu", ranks=(5,))
    np.testing.assert_array_equal(one.gather.recv_valid.numpy()[:, 0],
                                  tabs.gather.recv_valid.numpy()[:, 5])
    assert one.offsets.tolist() == [tp.offsets[5]]
    assert tabs.gather.send_start.dtype == torch.int32
    assert tabs.scatter.recv_dst[0].dtype == torch.int64
