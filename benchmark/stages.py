"""Arithmetic on the program's stage records (``utils/profiling.py``'s
``StageStats``, one list a sample), shared by the per-layer readers."""


def mean_stage_s(run, name: str):
    """A stage's seconds summed over the window's samples, over the number
    of samples; None when no sample ran the stage."""
    if not run.samples:
        return None
    total = [s["seconds"] for smp in run.samples for s in smp["stages"] if s["name"] == name]
    return sum(total) / len(run.samples) if total else None


def unstaged_s(run):
    """A sample's wall less the sum of its stages, averaged."""
    if not run.samples:
        return None
    return sum(smp["wall_s"] - sum(s["seconds"] for s in smp["stages"])
               for smp in run.samples) / len(run.samples)


def peak_stage(run):
    """The stage record with the largest device peak over all samples."""
    recs = [s for smp in run.samples for s in smp["stages"] if s["device_peak_mb"] is not None]
    return max(recs, key=lambda s: s["device_peak_mb"]) if recs else None
