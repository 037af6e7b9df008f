"""Hand-written CUDA kernels (csrc/), their nvcc build and their plain twins.
Importing them builds nothing: each source is compiled at its first launch."""


def fold_mapped(x, dim, size: int):
    """A custom op's vmap rule: x with its mapped dimension `dim` (None:
    unmapped, broadcast to `size`) moved to the front and folded into the
    next (the kernel's own batch), contiguous; None stays None."""
    if x is None:
        return None
    x = x.expand((size,) + x.shape) if dim is None else x.movedim(dim, 0)
    return x.flatten(0, 1).contiguous()


# After fold_mapped, which the kernel modules import from here.
from vislam_tpu_torch.ops.fed_kernel import fed_evolve  # noqa: E402
from vislam_tpu_torch.ops.harris_kernel import FAMILIES, response_nms  # noqa: E402
from vislam_tpu_torch.ops.match_kernel import match_top2  # noqa: E402
from vislam_tpu_torch.ops.threefry_kernel import threefry_categorical  # noqa: E402

__all__ = ["response_nms", "fed_evolve", "match_top2", "threefry_categorical"]


def _counters() -> dict:
    """name -> (wrapper, attribute that holds its count, key or None) of
    every kernel launch counter: one per response family, fed_evolve,
    match_top2, and of the match calls those batched (one A for several
    sets) and gated, and threefry_categorical."""
    out = {fam: (response_nms, "launches", fam) for fam in FAMILIES}
    out["fed_evolve"] = (fed_evolve, "launches", None)
    out["match_top2"] = (match_top2, "launches", None)
    out["match_top2_batched"] = (match_top2, "batched_launches", None)
    out["match_top2_gated"] = (match_top2, "gated_launches", None)
    out["threefry_categorical"] = (threefry_categorical, "launches", None)
    return out


def launch_counts() -> dict:
    """Every kernel launch counter of this process, by name."""
    return {name: getattr(obj, attr) if key is None else getattr(obj, attr)[key]
            for name, (obj, attr, key) in _counters().items()}


def reset_launch_counts() -> None:
    """Every kernel launch counter of this process set to 0."""
    for obj, attr, key in _counters().values():
        if key is None:
            setattr(obj, attr, 0)
        else:
            getattr(obj, attr)[key] = 0
