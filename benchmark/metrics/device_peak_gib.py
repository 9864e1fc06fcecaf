"""What the process took from the card, in GiB: the most bytes the
caching allocator reserved in the window (``probes.reserved_peak``: the
peak statistics are reset as the window opens, and each reset that the
program makes inside it first saves the peak it clears). What the cold
sample left reserved and the program keeps counts, as it would in the
window's first sample."""


def read(run):
    return None if run.reserved_peak_bytes is None else run.reserved_peak_bytes / 2**30
