"""Sequence-sharded batches (port of `vislam_tpu/parallel/batch_runner.py`).

Many sequences run at once, the batch sharded over the ranks of a mesh
axis ("seq"): each rank steps its contiguous slice with
`engine/batch.py::run_batch_scan` (one vmapped step per frame for the
slice), with no communication inside the step. Entry b of the global batch
draws under its global index's key (`sequence_key(seed, b)`, the
reference's split(PRNGKey(seed), B)[b], also under process_local), so a
sharded run equals the one-process batch entry by entry. `gather_batch` assembles the
slices on every rank afterwards.
"""

from __future__ import annotations

import torch

from vislam_tpu_torch.backend.ba import all_reduce_sum
from vislam_tpu_torch.engine.batch import SequenceInputs, run_batch_scan
from vislam_tpu_torch.engine.engine import VIOEngine
from vislam_tpu_torch.parallel.mesh import axis_groups, axis_position

# Types sent as another (exactly): collectives sum neither bool nor
# bfloat16 on every backend.
_WIRE = {torch.bool: torch.uint8, torch.bfloat16: torch.float32}


def _map(fn, tree):
    """fn over the leaves of nested tuples and NamedTuples."""
    if isinstance(tree, tuple):
        leaves = [_map(fn, x) for x in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return fn(tree)


def run_batch_sharded(eng: VIOEngine, states0, inputs_batch: SequenceInputs, kf_gt_pos0,
                      mesh, axis: str = "seq", seed: int = 0, process_local: bool = False,
                      noises=None):
    """`run_batch_scan` over this rank's slice of a batch sharded along
    `axis` of `mesh` (run in every rank).

    By default every rank passes the whole batch (states (B, ...), inputs
    (B, N, ...), kf_gt_pos0 (B, 3), noises[b] as run_batch_scan takes
    them); B must be divisible by the axis size, and the rank takes its
    contiguous B / size. With process_local each rank passes only its own
    slice, in rank order along the axis (`parallel.mesh.process_shard_range`
    picks it), so no rank stages another's sequences; the slices must be
    of one size (B divisible by the axis size), else every rank raises.

    Returns this rank's (final states (B_local, ...), FrameResult (B_local,
    N, ...)); `gather_batch` makes the whole batch of either.
    """
    index, count = axis_position(mesh, axis)
    b_in = inputs_batch.images.shape[0]
    if process_local:
        # The reference's rule, B divisible by the axis: every rank holds
        # as many sequences (sum(b)^2 == count * sum(b^2) over the axis).
        s1, s2 = all_reduce_sum(torch.tensor([b_in, b_in * b_in], dtype=torch.int32,
                                             device=eng.device),
                                axis_groups(mesh, axis)).tolist()
        if s1 * s1 != count * s2:
            raise ValueError(f"process_local needs as many sequences on every rank of "
                             f"axis {axis!r} (a batch divisible by {count}); this rank "
                             f"holds {b_in} of {s1}")
        lo, part = index * b_in, slice(None)
    else:
        if b_in % count:
            raise ValueError(f"batch {b_in} not divisible by mesh axis {count}")
        n = b_in // count
        lo, part = index * n, slice(index * n, (index + 1) * n)

    def local(x):
        return x[part].to(eng.device)

    inputs = SequenceInputs(*[local(x) for x in inputs_batch[:4]],
                            use_gt_scale=inputs_batch.use_gt_scale)
    return run_batch_scan(eng, _map(local, states0), inputs,
                          local(torch.as_tensor(kf_gt_pos0, dtype=torch.float32)),
                          seed=seed, noises=None if noises is None else noises[part],
                          offset=lo)


def gather_batch(tree, mesh, axis: str = "seq"):
    """Every rank's slice of a sharded batch (each tensor leaf's leading
    dimension, equal on every rank) -> the whole batch, in every rank, in
    rank order along `axis`: each slice placed into zeros and summed over
    the axis (an all_reduce, which every backend takes on every device)."""
    groups = axis_groups(mesh, axis)
    index, count = axis_position(mesh, axis)

    def whole(x):
        wire = _WIRE.get(x.dtype, x.dtype)
        b = x.shape[0]
        full = torch.zeros((b * count, *x.shape[1:]), dtype=wire, device=x.device)
        full[index * b:(index + 1) * b] = x.to(wire)
        return all_reduce_sum(full, groups).to(x.dtype)

    return _map(whole, tree)
