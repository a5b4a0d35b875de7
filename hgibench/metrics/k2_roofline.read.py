"""K2's share of its roofline: the least time of the grid-to-plane decode
(``roofline.k2_work``: the grid read and the plane written, over 3.35
TB/s) for the requests served in the profiled slice, over the device
time of the kernels K2's launches ran there (``csrc/hgi_codec.cu``; one
kernel a launch at depth 4, counted by ``cuda_codec.decode_launches``)."""

KERNELS = ("decode_tiles", "decode_level")
COUNTER = "K2"
PER_LAUNCH = 1


def read(ctx):
    return ctx.roofline("K2", KERNELS)
