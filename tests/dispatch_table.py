"""Each step's host<->device round trips in the port and in tiler_tpu on
the same clip:
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/dispatch_table.py [F H W]

The cuts_v2 clip (8 x 120 x 160 by default) at 16 palettes and
max_tiles=400, encoded once by each package on the CPU. Both count at
their call sites whatever the device, so the CPU gives the counts of an
encode on the card (or the TPU). Prints one JSON line per step: the
port's h2d, d2h and sync, tiler_tpu's h2d, d2h, jit and eager
(utils.dispatch of each package), then a line of the sums. Not a test:
tests/test_torch_dispatch.py holds the port's counts."""
import json
import sys

from tiler_tpu.config import EncoderConfig as JConfig
from tiler_tpu.pipeline.encoder import Encoder as JEncoder
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.tools.common import synthetic_clip_v2


def main(f=8, h=120, w=160):
    frames = synthetic_clip_v2(f, h, w)
    kw = dict(palette_count=16, max_tiles=400)
    port = Encoder(EncoderConfig(**kw), device='cpu')
    jax_enc = JEncoder(JConfig(**kw))
    assert port.run_all(frames, fps=24, fast_lzma=True) == \
        jax_enc.run_all(frames, fps=24, fast_lzma=True)
    mine = port.state.metrics['dispatches']
    theirs = jax_enc.state.metrics['dispatches']
    sums = {}
    for step in mine:
        row = {'step': step}
        row.update({f'port_{k}': mine[step][k]
                    for k in ('h2d', 'd2h', 'sync')})
        row.update({f'tiler_tpu_{k}': theirs[step][k]
                    for k in ('h2d', 'd2h', 'jit', 'eager')})
        for k, v in row.items():
            if k != 'step':
                sums[k] = sums.get(k, 0) + v
        print(json.dumps(row))
    print(json.dumps({'step': 'all', 'clip': [f, h, w], **sums}))


if __name__ == '__main__':
    main(*map(int, sys.argv[1:4]))
