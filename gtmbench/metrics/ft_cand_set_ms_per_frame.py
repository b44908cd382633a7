"""ft_cand_set_ms_per_frame: the host's set logic of FrameTiling's stage
2 (the span 'frame_tiling/cand_set': np.nonzero of the marks, the pair
dedup and the gathers, on the host before any upload) per frame
(ft_phases['cand_set']); part of ft_cand_feats_ms_per_frame. None for a
program that does not clock it."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, phases='ft_phases', phase='cand_set')
