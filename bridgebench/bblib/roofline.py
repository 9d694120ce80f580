"""The yardstick for the scoring kernel: operations and bytes one call of
``bid_argmax`` needs, counted from its plain formula and its operands.

A cell is one (live row, node) pair the inputs need: every node of the
row's partition, every node for a row of any partition, none for a row
whose partition has no nodes. Each cell costs the operations of the plain
formula at ``affinity_weight == 0`` (:data:`CELL_OPS`), whatever
implements it. Bytes are each operand read once and each output written
once. The least time of a call is the larger of operations over the
float32 peak outside the tensor cores and bytes over the memory
bandwidth; a kernel's share of its roofline is the least time of its
calls over their device time.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12

#: Operations per needed cell of the plain formula:
#: hash: ``a ^ b ^ salt`` (2), three ``h ^= h >> k`` (6), two multiplies
#: (2) — the row's and the node's own multiplies are per row and per node,
#: not per cell; unit: shift, convert, scale (3); bid: ``· jitter``,
#: ``− price`` (2); feasibility: partition compare (1), feature and and
#: compare (2), three capacity compares (3) and the four ands joining the
#: five tests (4); the masked select (1); the running argmax's compare and
#: select (2).
CELL_OPS = {
    "hash": 10,
    "unit": 3,
    "bid": 2,
    "partition": 1,
    "features": 2,
    "capacity": 3,
    "join": 4,
    "mask": 1,
    "argmax": 2,
}
OPS_PER_CELL = sum(CELL_OPS.values())

#: Bytes per node of the node operands: free [3] f32, partition i32,
#: features i32, price f32, normalised free [3] f32.
NODE_BYTES = 12 + 4 + 4 + 4 + 12
#: Bytes per live row of the row operands: demand [3] f32, partition i32,
#: required features i32, incumbent i32, normalised demand [3] f32.
ROW_BYTES = 12 + 4 + 4 + 4 + 12
#: Bytes per row of every row: the live mask (1) read, best f32 and choice
#: i32 written.
ALL_ROW_BYTES = 1 + 4 + 4


def needed_cells(node_part, job_part, live):
    """(needed cells, live rows) of one call, as 0-d tensors on the
    operands' device (no host sync): each live row against every node of
    its partition, every node for a row of any partition (code < 0), none
    for a partition without nodes."""
    import torch

    n = node_part.shape[0]
    np_ = node_part.long()
    sizes = torch.bincount(np_.clamp_min(0), weights=(np_ >= 0).double(), minlength=1)
    jp = job_part.long()
    inside = (jp >= 0) & (jp < sizes.shape[0])
    per_row = torch.where(inside, sizes[jp.clamp(0, sizes.shape[0] - 1)],
                          torch.where(jp < 0, n, 0))
    if live is None:
        live = torch.ones_like(jp, dtype=torch.bool)
    return (per_row * live).sum(), live.sum()


def call_count(cell_count: int, live: int, rows: int, nodes: int) -> tuple[int, int]:
    """(operations, bytes) of one call."""
    ops = cell_count * OPS_PER_CELL
    nbytes = nodes * NODE_BYTES + live * ROW_BYTES + rows * ALL_ROW_BYTES
    return ops, nbytes


def least_seconds(ops: int, nbytes: int) -> float:
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)
