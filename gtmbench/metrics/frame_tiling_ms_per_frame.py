"""frame_tiling_ms_per_frame: the frame_tiling step's wall per frame (step_times['frame_tiling'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, steps=('frame_tiling',))
