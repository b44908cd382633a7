"""The reader of the phase span that BENCHMARK.json reads: its value on a
synthetic window, None where the program does not clock the phase."""
import pytest

from gtmbench import cells
from gtmbench.run import Window


def _window(phases):
    recs = [{'wall_s': 12.0, 'step_times': {'dither': 6.0},
             'metrics': {'dither_phases': dict(phases)}}
            for _ in range(2)]
    return Window(encodes=recs, frames=32, calls=[], trace=None,
                  on_card=True)


@pytest.mark.parametrize('phases,want', [
    ({'prepare_kmeans': 4.5, 'kmeans_pp': 3.2, 'lloyd': 1.0},
     1e3 * 6.4 / 32),
    ({'prepare_kmeans': 4.5, 'quantize': 0.2, 'dither': 0.9}, None),
    ({}, None),
])
def test_kmeans_pp_ms_per_frame(phases, want):
    got = cells.reader('kmeans_pp_ms_per_frame')(_window(phases))
    assert got == (None if want is None else pytest.approx(want))


def test_kmeans_pp_reads_a_real_encode(tiny_cell):
    """A tiny encode on the CPU: the seeding is part of the k-means."""
    from gtmbench import run
    prog = run.setup(tiny_cell(), 'cpu', 0.0)
    _, rec = run.encode(prog)
    w = Window(encodes=[rec], frames=len(prog.frames), calls=[],
               trace=None, on_card=False)
    pp = cells.reader('kmeans_pp_ms_per_frame')(w)
    assert 0 < pp <= cells.reader('kmeans_ms_per_frame')(w)
