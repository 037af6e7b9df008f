"""Hand-written CUDA kernels (csrc/), their nvcc build and their plain twins."""


def fold_mapped(x, dim, size: int):
    """A custom op's vmap rule: x with its mapped dimension `dim` (None:
    unmapped, broadcast to `size`) moved to the front and folded into the
    next (the kernel's own batch), contiguous; None stays None."""
    if x is None:
        return None
    x = x.expand((size,) + x.shape) if dim is None else x.movedim(dim, 0)
    return x.flatten(0, 1).contiguous()
