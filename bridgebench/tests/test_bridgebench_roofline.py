"""bid_argmax's operation and byte count on a tiny operand set, worked out
by hand."""

from __future__ import annotations

import torch

from bblib import roofline

# three nodes: two in partition 0, one in partition 1; four rows of
# partitions 0, 1, any and 0, the last not live
NODE_PART = [0, 0, 1]
JOB_PART = [0, 1, -1, 0]
LIVE = [True, True, True, False]


def test_cells_by_hand():
    # row 0: the two nodes of partition 0; row 1: the one of partition 1;
    # row 2: all three; row 3 is not live
    cells, live = roofline.needed_cells(
        torch.tensor(NODE_PART, dtype=torch.int32), torch.tensor(JOB_PART, dtype=torch.int32),
        torch.tensor(LIVE))
    assert (int(cells), int(live)) == (2 + 1 + 3, 3)
    # a partition without nodes needs no cell
    cells, _ = roofline.needed_cells(
        torch.tensor(NODE_PART, dtype=torch.int32), torch.tensor([7], dtype=torch.int32), None)
    assert int(cells) == 0


def test_ops_and_bytes_by_hand():
    assert roofline.OPS_PER_CELL == 10 + 3 + 2 + 1 + 2 + 3 + 4 + 1 + 2 == 28
    ops, nbytes = roofline.call_count(6, live=3, rows=4, nodes=3)
    assert ops == 6 * 28
    # nodes: 3 × (12 + 4 + 4 + 4 + 12); live rows: 3 × (12 + 4 + 4 + 4 + 12);
    # every row: 4 × (1 + 4 + 4)
    assert nbytes == 3 * 36 + 3 * 36 + 4 * 9 == 252
    assert roofline.least_seconds(ops, nbytes) == max(168 / 67e12, 252 / 3.35e12)


def test_the_run_counts_the_same_cells():
    from bblib.loop import LaunchCounter

    n = len(NODE_PART)
    counter = LaunchCounter()
    try:
        import slurm_bridge_tpu_torch.solver.auction as auction

        f32 = lambda *s: torch.zeros(*s, dtype=torch.float32)  # noqa: E731
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
        auction.bid_argmax(
            f32(n, 3), i32(NODE_PART), i32([0] * n), f32(n), f32(4, 3), i32(JOB_PART),
            i32([0] * 4), i32([-1] * 4), f32(4, 3), f32(n, 3), 0,
            jitter=1.0, affinity_weight=0.0, num_nodes=n, live=torch.tensor(LIVE),
        )
    finally:
        calls = counter.close()
    assert calls == [(6, 3, 4, 3)]
