"""The transforms' least time (costs.py:ntt_work of the inverse transform
and of the 8n transform; bytes at 3.35 TB/s or IMAD slots at 1.67e13/s,
the larger) over the device time of all the calls' kernels, copies and
memsets, in %."""


def read(t):
    return t.roofline_pct()
