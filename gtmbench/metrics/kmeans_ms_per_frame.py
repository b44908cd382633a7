"""kmeans_ms_per_frame: Dither's k-means (k-means++ draws and Lloyd
iterations) per frame (dither_phases['prepare_kmeans'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, phases='dither_phases',
                        phase='prepare_kmeans')
