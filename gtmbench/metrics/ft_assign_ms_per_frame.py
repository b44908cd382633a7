"""ft_assign_ms_per_frame: FrameTiling's stage 3 (query features, K1's
prepare and the 1-NN, the forward fill) per frame (ft_phases['assign'])."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, phases='ft_phases', phase='assign')
