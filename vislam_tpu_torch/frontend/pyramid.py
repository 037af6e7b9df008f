"""Image pyramid (port of `vislam_tpu/frontend/pyramid.py::build_pyramid`)."""

from __future__ import annotations


def build_pyramid(image, num_levels: int):
    """List of `num_levels` images, each a 2x2-mean downsample of the last.

    Keeps the input dtype (bf16 by default, `FrontendConfig.image_dtype`):
    each mean is taken in float32 and rounded back once, which is how the
    reference's jnp.mean treats bf16 — the levels are bit-identical.
    """
    levels = [image]
    cur = image
    for _ in range(num_levels - 1):
        h, w = cur.shape
        cur = cur[: h - h % 2, : w - w % 2]
        cur = cur.reshape(h // 2, 2, w // 2, 2).float().mean(dim=(1, 3))
        cur = cur.to(image.dtype)
        levels.append(cur)
    return levels
