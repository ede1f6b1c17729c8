"""The device memory allocated at its peak in the window (GiB): the peak statistics
are reset at the window's start, so set-up's memory search is not counted."""


def read(rec):
    return rec.window_peak_bytes / 2**30 if rec.window_peak_bytes else None
