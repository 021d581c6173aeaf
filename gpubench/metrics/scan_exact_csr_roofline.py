"""Share, in %, of the device time of the kernels that did the batch's
list scan that the least time of that work would take
(work/scan_exact_csr.py), per batch. The kernels summed are named here, so a
kernel that replaces them gets a metric file of its own."""

from gpubench.work import scan_exact_csr as work

KERNELS = ("scan_exact_csr_kernel",)


def read(run):
    if run.trace is None or run.view is None or not run.calls:
        return None
    seconds = sum(s for name, s in run.trace.kernels.items()
                  if any(k in name for k in KERNELS))
    if not seconds:
        return None
    least, _ = work.least_seconds(run.view)
    return 100.0 * least * len(run.calls) / seconds
