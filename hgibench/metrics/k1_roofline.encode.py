"""K1's share of its roofline: the least time of the plane-to-grid
encode (``roofline.k1_work``: the plane read, the grid and a lossy
preset's reconstruction written, over 3.35 TB/s) for the requests served
in the profiled slice, over the device time of the kernels K1's
launches ran there (``csrc/hgi_codec.cu``; one kernel a launch at depth
4, counted by ``cuda_codec.encode_launches``)."""

KERNELS = ("encode_tiles", "encode_level", "encode_lossless")
COUNTER = "K1"
PER_LAUNCH = 1


def read(ctx):
    return ctx.roofline("K1", KERNELS)
