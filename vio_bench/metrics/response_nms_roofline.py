"""The share of its roofline that the `vislam_torch::response_nms` op reaches in the
traced window: the least time its calls' work needs (`roofline.py`, from
the cell's shapes) over the device time of its kernels."""

from vio_bench.roofline import share

KERNELS = ("response_nms_kernel",)


def read(ctx):
    return share(ctx, "response_nms", KERNELS)
