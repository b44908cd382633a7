"""yliluoma_ms_per_frame: Dither's Yliluoma-2 scan per frame, the span
'dither/yliluoma' (the key dedup, the plans of the unique keys and the
pixels' picks, up to and with the scan's device synchronize)
(dither_phases['yliluoma']); part of dither_ms_per_frame. None for a
program that does not clock it."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, phases='dither_phases', phase='yliluoma')
