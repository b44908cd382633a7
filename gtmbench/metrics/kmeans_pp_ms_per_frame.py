"""kmeans_pp_ms_per_frame: Dither's k-means++ seeding (the span
'dither/kmeans_pp' in ops.kmeans.kmeans_core, once a keyframe) per
frame (dither_phases['kmeans_pp']); part of kmeans_ms_per_frame. None
for a program that does not clock it."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, phases='dither_phases', phase='kmeans_pp')
