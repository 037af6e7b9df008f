"""The share of its roofline that the `vislam_torch::match_top2` op reaches in the
traced window: the least time its calls' work needs (`roofline.py`, from
the cell's shapes) over the device time of its kernels."""

from vio_bench.roofline import share

KERNELS = ("match_top2_kernel", "reset_kernel(")


def read(ctx):
    return share(ctx, "match_top2", KERNELS)
