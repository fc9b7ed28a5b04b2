"""The share of the traced window in which no kernel, copy or memset ran
on the card (the window is the "bench.window" span around the traced
calls), in %: device_idle_pct.msm and .ntt, each in its cells."""


def read(t):
    if not t.trace.device or t.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.trace.busy_s / t.trace.window_s)
