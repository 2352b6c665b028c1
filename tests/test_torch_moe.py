"""The expert layer's pieces on the CPU (``tdax_torch.ops.moe``): the
dispatch's order and ends, the plain grouped product, the combine's
fixed order, the load tally that runs only while a profiler records, and
the picks kept only while recorded.
The grouped launch itself is held against the plain version on the card
(``tests/test_torch_moe_cuda.py``)."""

import torch
from torch.profiler import ProfilerActivity, profile

from tdax_torch.ops import moe


def test_dispatch_sorts_pairs_by_expert_in_token_order():
    picked = torch.tensor([[2, 0], [0, 3], [2, 1]])
    order, ends, tokens, counts = moe.dispatch(picked, 5)
    flat = picked.reshape(-1)
    assert flat[order].tolist() == [0, 0, 1, 2, 2, 3]
    assert tokens.tolist() == [0, 1, 2, 0, 2, 1]  # each expert's rows in token order
    assert counts.tolist() == [2, 1, 2, 1, 0]
    assert ends.tolist() == [2, 3, 5, 6, 6] and ends.dtype == torch.int32


def test_plain_grouped_product_is_each_groups_product():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((7, 4), generator=g), torch.randn((3, 4, 5), generator=g)
    ends = torch.tensor([2, 2, 7], dtype=torch.int32)  # an empty group in the middle
    got = moe.grouped_mm_plain(x, w, ends)
    want = torch.cat([x[:2] @ w[0], x[2:] @ w[2]])
    torch.testing.assert_close(got, want)
    assert moe.grouped_mm(x, w, ends).equal(got)  # CPU tensors take the plain version


def test_combine_puts_rows_back_and_sums_in_choice_order():
    picked = torch.tensor([[1, 0], [0, 1]])
    weights = torch.tensor([[0.25, 0.75], [2.0, 0.5]])
    order, _, tokens, _ = moe.dispatch(picked, 2)
    y = torch.arange(4, dtype=torch.float32)[:, None].repeat(1, 3) + 1  # row i of dispatch order
    got = moe.combine(y, order, weights)
    pair_rows = torch.empty(4)
    pair_rows[order] = torch.arange(4, dtype=torch.float32) + 1  # the row each pair got
    want = (pair_rows.view(2, 2) * weights).sum(1)[:, None].expand(2, 3)
    torch.testing.assert_close(got, want)
    assert torch.equal(moe.combine(y, order, weights), got)


def test_load_is_tallied_only_while_a_profiler_records():
    g = torch.Generator().manual_seed(1)
    layer = {"router_w": torch.randn((8, 4), generator=g), "router_bias": torch.zeros(4),
             "experts_gate_up": torch.randn((4, 8, 6), generator=g),
             "experts_down": torch.randn((4, 3, 8), generator=g)}
    h = torch.randn((10, 8), generator=g)
    moe.LOAD.take()
    moe.moe(h, layer, 2, 1.0, 5)
    assert moe.LOAD.take() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        moe.moe(h, layer, 2, 1.0, 5)
        moe.moe(h, layer, 2, 1.0, 5)
    load = moe.LOAD.take()
    assert list(load) == [5] and sum(load[5]) == 2 * 10 * 2
    bal = moe.balance(load)[5]
    assert bal["max_over_mean"] == max(load[5]) / 10 and bal["min_over_mean"] == min(load[5]) / 10
    assert moe.LOAD.take() == {}


def test_picks_are_kept_only_while_recorded():
    g = torch.Generator().manual_seed(2)
    layer = {"router_w": torch.randn((8, 4), generator=g), "router_bias": torch.zeros(4),
             "experts_gate_up": torch.randn((4, 8, 6), generator=g),
             "experts_down": torch.randn((4, 3, 8), generator=g)}
    h = torch.randn((10, 8), generator=g)
    moe.moe(h, layer, 2, 1.0, 3)
    assert moe.PICKS.take() == {}
    with moe.PICKS.record():
        moe.moe(h, layer, 2, 1.0, 3)
        moe.moe(h, layer, 2, 1.0, 4)
    moe.moe(h, layer, 2, 1.0, 5)
    picks = moe.PICKS.take()
    assert list(picks) == [3, 4]
    assert torch.equal(picks[3], moe.route(h, layer["router_w"], layer["router_bias"], 2, 1.0)[0])
    assert moe.PICKS.take() == {}
