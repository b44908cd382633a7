"""dither_ms_per_frame: the dither step's wall per frame (step_times['dither'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, steps=('dither',))
