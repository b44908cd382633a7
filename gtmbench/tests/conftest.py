"""The benchmark's own tests, on the CPU at tiny sizes (run from the
repository root: python3 -m pytest gtmbench/tests -q)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {'frames': 16, 'height': 120, 'width': 160}
# the tiny cell's limits: the real cells'
TINY_LIMITS = {'k1_gap': 3e-5, 'kmodes_gap': 0.0, 'kmeans_gap': 0.06,
               'kmeans_step_gain': 1e-3}


@pytest.fixture(autouse=True, scope='session')
def _threads():
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def tiny_cell():
    """A cell of BENCHMARK.json cut to 16 x 120 x 160 frames."""
    from gtmbench import cells

    def make(name='default.cuts1080', limits=TINY_LIMITS):
        c = cells.load(name)
        c.traffic = dict(c.traffic, **TINY)
        c.limits = dict(limits)
        return c
    return make
