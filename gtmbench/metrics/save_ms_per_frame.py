"""save_ms_per_frame: the save step's wall per frame (step_times['save'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, steps=('save',))
