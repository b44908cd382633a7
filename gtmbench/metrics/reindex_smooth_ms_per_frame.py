"""reindex_smooth_ms_per_frame: the Reindex and Smooth steps' walls per
frame (step_times['reindex'] + step_times['smooth'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, steps=('reindex', 'smooth'))
