"""The benchmark's frozen clip generators against the port's originals."""
import json
import os

import numpy as np
import pytest

from gtmbench.traffic import generators
from tiler_tpu_torch.tools import common

from conftest import ROOT


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('mine,theirs', [
    (generators.cuts_v2, common.synthetic_clip_v2),
    (generators.noise, common.synthetic_clip)])
def test_generator_equals_the_ports(mine, theirs, seed):
    for f, h, w in ((16, 120, 160), (16, 1080, 1920)):
        assert np.array_equal(mine(f, h, w, seed), theirs(f, h, w, seed))


def test_make_gives_the_traffic_files_clip():
    t = {'generator': 'noise', 'clip_seed': 2**31 + 5, 'frames': 2,
         'height': 16, 'width': 24}
    a = generators.make(t)
    assert a.shape == (2, 16, 24, 3) and a.dtype == np.uint8
    assert np.array_equal(a, generators.make(t))
    assert not np.array_equal(a, generators.make(dict(t, clip_seed=6)))


@pytest.mark.parametrize('name', ['cuts1080', 'noise1080'])
def test_every_traffic_file_fixes_its_clip(name):
    with open(os.path.join(ROOT, 'gtmbench', 'traffic', name + '.json')) as fh:
        assert isinstance(json.load(fh)['clip_seed'], int)
