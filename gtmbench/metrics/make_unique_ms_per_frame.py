"""make_unique_ms_per_frame: the make_unique step's wall per frame (step_times['make_unique'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, steps=('make_unique',))
