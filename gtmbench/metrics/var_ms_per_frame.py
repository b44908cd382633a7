"""var_ms_per_frame: Dither's VAR quantizer per frame, the seconds of the
spans 'dither/var' (one a group, on the quantize pool's threads, summed
over the jobs that ran side by side: the host's work, not a wall)
(dither_phases['var']). None for a program that does not clock it."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, phases='dither_phases', phase='var')
