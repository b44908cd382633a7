"""ft_cand_feats_ms_per_frame: FrameTiling's stage 2 (the candidate set
of each keyframe and its PsyV features) per frame (ft_phases['cand_feats']);
it holds ft_cand_set_ms_per_frame."""
from gtmbench.metrics._steps import ms_per_frame


def read(window):
    return ms_per_frame(window, phases='ft_phases', phase='cand_feats')
