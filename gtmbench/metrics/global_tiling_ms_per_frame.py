"""global_tiling_ms_per_frame: the global_tiling step's wall per frame (step_times['global_tiling'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, steps=('global_tiling',))
