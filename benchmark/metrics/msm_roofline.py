"""msm_roofline.l8 and .l12: the MSM calls' least time (costs.py: the
accumulate, reduction, Horner, slice adds and any affine inverse, counted
from the inputs at the configuration's window; bytes at 3.35 TB/s or IMAD
slots at 1.67e13/s, the larger) over the device time of all the calls'
kernels, copies and memsets, in %."""


def read(t):
    return t.roofline_pct()
