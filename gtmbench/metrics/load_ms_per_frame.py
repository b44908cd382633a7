"""load_ms_per_frame: the load step's wall per frame (step_times['load'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, steps=('load',))
