"""What `correct` has to catch, at a tiny size on the CPU: the control
(the reference's 1-NN in TF32 in the program's place), and the timed path
broken underneath the harness: a step that returns its state unchanged
(FrameTiling), half of each search's queries left out, a search answer
altered where it is produced, the stream altered where Save produces it,
Dither's palette k-means stopped after its seeding, and GlobalTiling's
KModes solved from the wrong start. One card has no exchange between
chips to leave out."""
import pytest
import torch

from gtmbench import run
from gtmbench.reference import nn
from tiler_tpu_torch.ops import nn_kernels
from tiler_tpu_torch.pipeline import (dither_step, frame_tiling,
                                      global_tiling, save)


def _run(cell, **kw):
    return run.run_cell(cell, 4, 0.0, False, device='cpu', **kw)


def test_the_program_passes(tiny_cell):
    r = _run(tiny_cell())
    assert r['correct'] is True, r['checks']


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_the_tf32_control_fails(tiny_cell, seed):
    r = run.run_cell(tiny_cell(), seed, 0.0, False, device='cpu',
                     control=nn.nearest_tf32)
    assert r['correct'] is False
    assert r['checks']['k1_gap']['value'] > r['checks']['k1_gap']['limit']


def test_an_altered_answer_fails(tiny_cell, monkeypatch):
    orig = nn_kernels.nearest_1

    def altered(q, c):
        idx, err = orig(q, c)
        idx = idx.clone()
        idx[::7] = (idx[::7] + 1) % c.n_c
        return idx, err
    monkeypatch.setattr(nn_kernels, 'nearest_1', altered)
    r = _run(tiny_cell())
    assert r['correct'] is False
    assert r['checks']['k1_gap']['value'] > r['checks']['k1_gap']['limit']


def test_half_the_queries_left_out_fails(tiny_cell, monkeypatch):
    orig = nn_kernels.nearest_1

    def half(q, c):
        n = len(q) // 2
        idx, err = orig(q[:n], c)
        pad = torch.zeros(len(q) - n, dtype=idx.dtype)
        return torch.cat([idx, pad]), torch.cat([err, pad.float()])
    monkeypatch.setattr(nn_kernels, 'nearest_1', half)
    r = _run(tiny_cell())
    assert r['correct'] is False
    assert r['checks']['k1_gap']['value'] > r['checks']['k1_gap']['limit']


def test_an_altered_stream_fails(tiny_cell, monkeypatch):
    orig = save.run_save

    def altered(state, fast_lzma):
        blob = bytearray(orig(state, fast_lzma))
        blob[len(blob) // 2] ^= 0xFF
        return bytes(blob)
    monkeypatch.setattr(save, 'run_save', altered)
    r = _run(tiny_cell())
    assert r['correct'] is False
    assert r['checks']['stream_decode_errors']['value'] == 1


def test_a_step_that_leaves_its_state_fails(tiny_cell, monkeypatch):
    monkeypatch.setattr(frame_tiling, 'run_frame_tiling', lambda st: st)
    r = _run(tiny_cell())
    assert r['correct'] is False
    # K1 never ran, so nothing of its answers was there to judge
    assert r['checks']['k1_gap']['value'] is None


def test_a_kmeans_stopped_after_its_seeding_fails(tiny_cell, monkeypatch):
    """Dither's palette k-means returns its k-means++ start's grouping."""
    orig = dither_step.kmeans_core
    monkeypatch.setattr(dither_step, 'kmeans_core',
                        lambda x, k, **kw: orig(x, k, max_iters=0, **kw))
    r = _run(tiny_cell())
    assert r['correct'] is False
    c = r['checks']['kmeans_step_gain']
    assert c['value'] > c['limit']


@pytest.mark.parametrize('name', ['default.cuts1080',
                                  'kmodes_restarts7.cuts1080'])
def test_kmodes_from_the_wrong_start_fails(tiny_cell, monkeypatch, name):
    """GlobalTiling solves every bin once from its first line: one
    restart where the configuration states seven, the wrong start where
    it states the smallest byte sum's."""
    orig = global_tiling.kmodes_batch_gather

    def first(sigs, sel, ks, starts, *a, **kw):
        return orig(sigs, sel, ks, [0] * len(starts), *a, **kw)
    monkeypatch.setattr(global_tiling, 'kmodes_batch_gather', first)
    r = _run(tiny_cell(name))
    assert r['correct'] is False
    c = r['checks']['kmodes_gap']
    assert c['value'] > c['limit']
