"""Share of its roofline of the ``partial_ratio`` kernel, in percent: the least
time of every launch in the window (``kernels.py``'s counts over the
launch's own strings, kept by ``probes.batched_scores``) over the device
time the trace gives the kernel. None where the window launched it not."""

from benchmark.devtrace import kernel_seconds
from benchmark.kernels import roofline_pct


def read(run):
    if run.trace is None:
        return None
    return roofline_pct("partial_ratio", run.probes.get("batched", []),
                        kernel_seconds(run.trace, "partial_ratio"))
