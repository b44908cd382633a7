"""Where the port's and tiler_tpu's streams of the plasma clip part, and
why:
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/plasma_ft_ties.py [F H W]

The clip of tools/gen_sample_stream.py (tiler_tpu_torch.tools.common.
sample_clip, 48 x 176 x 320 by default) at that tool's config, encoded by
both packages on the CPU. Prints one JSON line: each package's bytes
with fast and with default LZMA, the first step whose output differs,
whether the port's FrameTiling resumed from tiler_tpu's state after
GlobalTiling gives the port's own cells, and for every cell whose own
1-NN query gave another winner: the gap between the two winners'
distances relative to |q|^2 + |c|^2 (the port's f32 features, float64
sums; test_torch_configs_fields.RTOL_FT bounds it), and which winner is
the nearer in float64 (float64 features of the rendered tiles). Not a
test: tests/test_torch_configs_fields.py holds the same at a cut of the
clip."""
import json
import sys

import numpy as np
import torch

from test_torch_configs_fields import (_FT, PLASMA, _first_difference,
                                       _ft_gaps, plasma_encodes)
from test_torch_steps import _f64_feats, _yuv_wavelet
from tiler_tpu_torch.decode import decode_video
from tiler_tpu_torch.ops.stats import psnr
from tiler_tpu_torch.pipeline.load import split_into_tiles
from tiler_tpu_torch.tools.common import sample_clip


def main(argv):
    f, h, w = (int(a) for a in argv) if argv else (48, 176, 320)
    frames = sample_clip(w, h, f)
    run = plasma_encodes(frames)
    (jenc, jfast, jsnaps), (enc, pfast, snaps) = run['jax'], run['port']
    got, want = snaps['frame_tiling'], jsnaps['frame_tiling']
    cells = np.flatnonzero(np.stack([got[k] != want[k] for k in _FT])
                           .any(0).ravel())
    st = run['resumed']
    queried = st.changed_mask.reshape(f, -1).copy()
    queried[[s for s, _ in st.keyframes]] = True
    own = cells[queried.ravel()[cells]]
    gaps = _ft_gaps(got, want, frames, PLASMA, max_share=1.0)
    # which of the two winners is the nearer in float64
    q = _yuv_wavelet(split_into_tiles(frames, st.tilemap_h, st.tilemap_w)
                     [own].reshape(len(own), 64, 3) / 255.0)
    kf = st.kf_of_frame()[own // st.tilemap_size]
    d = [((q - _f64_feats(s['tiles_pal'][s['tm_tile'].ravel()[own]],
                          s['palettes_rgb'][kf, s['tm_pal'].ravel()[own]],
                          s['tm_h'].ravel()[own], s['tm_v'].ravel()[own]))
          ** 2).sum(1) for s in (got, want)]
    print(json.dumps({
        'shape': [f, h, w], 'gtm_bytes_fast': [len(pfast), len(jfast)],
        'gtm_bytes_default': [len(enc.save(False)), len(jenc.save(False))],
        'first_difference': _first_difference(snaps, jsnaps),
        'resumed_is_own': all(np.array_equal(getattr(st, k), got[k])
                              for k in _FT),
        'cells_differ': len(cells), 'queried_differ': len(own),
        'cells': int(got['tm_tile'].size),
        'max_gap_of_norms': float(gaps.max()) if gaps.size else 0.0,
        'port_nearer_f64': int((d[0] < d[1]).sum()),
        'jax_nearer_f64': int((d[1] < d[0]).sum()),
        'equal_f64': int((d[0] == d[1]).sum()),
        'psnr': [psnr(decode_video(pfast)[0], frames),
                 psnr(decode_video(jfast)[0], frames)]}))


if __name__ == '__main__':
    torch.set_num_threads(4)
    main(sys.argv[1:])
