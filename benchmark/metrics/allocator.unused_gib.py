"""What the caching allocator held but did not use at the end of the
peak stage, in GiB: reserved less allocated peak, the fragmentation."""

from benchmark.stages import peak_stage


def read(run):
    s = peak_stage(run)
    if s is None or s["device_reserved_mb"] is None:
        return None
    return (s["device_reserved_mb"] - s["device_peak_mb"]) / 1024
