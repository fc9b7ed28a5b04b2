"""Device ms a call of torch's own kernels (its digit recoding, sorts,
gathers and copies): kernels in torch's namespaces (devtrace.TORCH_KERNEL),
whatever the program names its own."""


def read(t):
    if not any(cat == "kernel" for _lo, _hi, cat, _n in t.trace.device):
        return None
    return 1e3 * t.trace.torch_kernel_seconds() / t.calls
