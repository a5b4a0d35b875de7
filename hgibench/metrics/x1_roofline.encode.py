"""X1's share of its roofline: the least time of the device rANS encode
(``roofline.x1_work``: the larger of its bytes over 3.35 TB/s and
``X1_OPS_PER_SYMBOL`` operations a coded symbol over 33.454 T/s) for the
requests served in the profiled slice, over the device time of X1's
three kernels there (``csrc/hgi_entropy.cu``, counted by
``tpurans.rans_launches``); its memset is not counted."""

KERNELS = ("rans_histogram", "rans_normalize", "rans_encode_lanes")
COUNTER = "X1"
PER_LAUNCH = 3


def read(ctx):
    return ctx.roofline("X1", KERNELS)
