"""100 x (1 - the union of the device's kernel, copy and memset intervals
over the traced window's length), from the trace."""


def read(run):
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
