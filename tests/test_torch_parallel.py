"""The port's multi-device encoder against its own single-device encode
and against the JAX package, on the CPU: the exact GOP-sharded encode
(threads and processes), the ('gop','frame') mesh, the sharded ops and
their pipeline call sites. The byte-identity contract is the JAX
package's (tiler_tpu/parallel/mesh_pipeline.py, gop_exact.py): an N-way
encode writes the bytes of the 1-device encode, and here, at these small
clips, the bytes of tiler_tpu too. A mesh of ['cpu'] * N is N logical
shards of one device, as the JAX package's tests run 8 virtual CPU
devices."""
import jax_native_lock  # noqa: F401  (first: builds tiler_tpu's library)

import json
import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _dryrun_clip
from tiler_tpu.config import EncoderConfig as JaxConfig
from tiler_tpu.ops import features as jfeatures
from tiler_tpu.ops import kmeans as jkmeans
from tiler_tpu.ops import kmodes as jkmodes
from tiler_tpu.parallel import mesh as jmesh
from tiler_tpu.parallel import sharded_ops as jsharded
from tiler_tpu.pipeline import global_tiling as jgt
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu.pipeline.unique import compute_unique_fwd as jcuf
from tiler_tpu_torch import __main__ as cli
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.ops import features, kmodes, nn_kernels
from tiler_tpu_torch.ops.kmeans import kmeans_core
from tiler_tpu_torch.parallel import distributed as pdist
from tiler_tpu_torch.parallel import gop_exact, sharded_ops
from tiler_tpu_torch.parallel.mesh import make_mesh
from tiler_tpu_torch.parallel.mesh_pipeline import map_rows, mesh_ok, replicate
from tiler_tpu_torch.pipeline import frame_tiling, stream
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.pipeline.global_tiling import run_global_tiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the shapes here are tiny and several test processes share the cores:
# one thread each keeps them from spinning on each other
torch.set_num_threads(1)

MESH_CFG = dict(palette_count=8, tile_palette_size=16, max_tiles=120)
# the JAX package's own tests' seed (tests/conftest.py)
SEED = 42381337


def _mesh(n):
    return make_mesh(devices=['cpu'] * n)


def _multi_scene_clip(rng, scenes=3, frames_per=5, h=64, w=80):
    """Clip with hard cuts so keyframe detection yields multiple GOPs
    (tests/test_parallel.py's)."""
    out = []
    for s in range(scenes):
        base = np.zeros((h, w, 3), np.float64)
        base[..., s % 3] = 200
        base += np.linspace(0, 55, w)[None, :, None] * ((-1) ** s)
        blob = rng.integers(0, 60, (h, w, 3))
        for f in range(frames_per):
            fr = base + np.roll(blob, f * 3, axis=1)
            out.append(np.clip(fr, 0, 255).astype(np.uint8))
    return np.stack(out)


@pytest.fixture(scope='module')
def dryrun():
    """The dryrun clip, tiler_tpu's stream and metrics of it, and the
    port's 1-device stream and Encoder."""
    frames = _dryrun_clip()
    jenc = JaxEncoder(JaxConfig(**MESH_CFG))
    jblob = jenc.run_all(frames, fast_lzma=True)
    enc = Encoder(EncoderConfig(**MESH_CFG), device='cpu')
    blob = enc.run_all(frames, fast_lzma=True)
    return dict(frames=frames, jblob=jblob, jmetrics=jenc.state.metrics,
                blob=blob, enc=enc)


@pytest.fixture(scope='module')
def scenes():
    """The 3-scene clip at max_tiles=300: tiler_tpu's stream, the port's
    1-device stream and keyframe count."""
    frames = _multi_scene_clip(np.random.default_rng(SEED))
    jblob = JaxEncoder(JaxConfig(palette_count=8, max_tiles=300)).run_all(
        frames, fps=24.0, fast_lzma=True)
    enc = Encoder(EncoderConfig(palette_count=8, max_tiles=300),
                  device='cpu')
    blob = enc.run_all(frames, fps=24.0, fast_lzma=True)
    return dict(frames=frames, jblob=jblob, blob=blob,
                n_kf=len(enc.state.keyframes))


@pytest.fixture(scope='module')
def two_scenes():
    """The 2-scene clip at max_tiles=200 and the port's 1-device stream."""
    frames = _multi_scene_clip(np.random.default_rng(SEED), scenes=2,
                               frames_per=4)
    blob = Encoder(EncoderConfig(palette_count=8, max_tiles=200),
                   device='cpu').run_all(frames, fps=24.0, fast_lzma=True)
    return frames, blob


# -- f2: the mesh --------------------------------------------------------------

@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_mesh_shape(n):
    """The ('gop','frame') axes of the JAX package's make_mesh: 8 shards
    give 2 x 4."""
    mesh = _mesh(n)
    want = jmesh.make_mesh(n)
    assert mesh.axis_names == want.axis_names == ('gop', 'frame')
    assert mesh.devices.shape == want.devices.shape
    if n == 8:
        assert dict(zip(mesh.axis_names, mesh.devices.shape)) == \
            {'gop': 2, 'frame': 4}
    assert mesh.flat == [torch.device('cpu')] * n
    assert make_mesh(devices=['cpu'] * n, gop_axis=1).devices.shape == \
        (1, n)


def test_mesh_without_devices_and_mesh_ok():
    """Without devices=, a mesh is made of CUDA cards only: on a host
    without one it raises, and never falls back to CPU shards. mesh_ok
    (the hash-partitioned MakeUnique's rule) takes more than one shard,
    a power of two."""
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(ValueError, match=r'only 0 device\(s\) available'):
        make_mesh(4)
    with pytest.raises(ValueError, match='at least one device'):
        make_mesh()
    assert make_mesh(devices=['cuda'] * 2).flat == \
        [torch.device('cuda', 0)] * 2
    assert [mesh_ok(_mesh(n)) for n in (1, 2, 3, 4, 6, 8)] == \
        [False, True, False, True, False, True]
    assert not mesh_ok(None) and not mesh_ok(['cpu', 'cpu'])


def test_replicate_copies_once_per_device():
    t = torch.arange(12)
    rep = replicate(_mesh(4), t)
    assert list(rep) == [torch.device('cpu')] and rep[t.device] is t
    made = []
    rep = replicate(_mesh(4), t, make=lambda v: made.append(v) or -v)
    assert len(made) == 1 and made[0] is t
    assert torch.equal(rep[t.device], -t)


@pytest.mark.parametrize('n_dev', [1, 3, 8])
@pytest.mark.parametrize('n_rows', [0, 5, 23])
def test_map_rows_cuts_and_joins_in_shard_order(n_dev, n_rows):
    """map_rows runs the function once per shard with rows (cut alike
    when a tuple, along dim) and joins the results in row order: tensors
    gathered, anything else one entry per shard, None where a shard got
    no rows; zero rows still run the function once."""
    mesh = _mesh(n_dev)
    a = torch.arange(n_rows * 3).reshape(n_rows, 3)
    b = np.arange(n_rows)
    seen = []

    def fn(ra, rb, scale, tag):
        assert isinstance(rb, np.ndarray) and len(ra) == len(rb)
        seen.append(len(rb))
        return ra * scale, torch.from_numpy(rb + 1), (tag, len(rb))
    got, got_b, tags = map_rows(mesh, fn, (a, b), torch.tensor(2), 'x')
    assert torch.equal(got, a * 2)
    assert torch.equal(got_b, torch.from_numpy(b + 1))
    assert sum(seen) == n_rows and len(seen) == max(1, min(n_dev, n_rows))
    assert len(tags) == n_dev
    assert [t[1] for t in tags if t is not None] == seen
    cols = map_rows(mesh, lambda r: r + 1, a.T.contiguous(), dim=1)
    assert torch.equal(cols, a.T + 1)


# -- f3: the sharded ops -------------------------------------------------------

def test_sharded_features_match_single():
    rng = np.random.default_rng(SEED)
    tiles = rng.integers(0, 256, (500, 8, 8, 3)).astype(np.uint8)
    want = np.asarray(jfeatures.psyv_features_rgb(tiles, use_wavelets=True))
    got = sharded_ops.sharded_psyv_features(_mesh(8), tiles,
                                            use_wavelets=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    one = features.psyv_features_rgb(torch.from_numpy(tiles),
                                     use_wavelets=True).numpy()
    assert got.tobytes() == one.tobytes()


def test_sharded_kmeans_shard_invariance():
    """N-shard k-means equals the 1-shard run (tests/test_parallel.py's
    check): the labels exactly, the summed centroids to f32 rounding."""
    rng = np.random.default_rng(SEED)
    centers = rng.normal(0, 10, (4, 32))
    pts = np.concatenate(
        [c + rng.normal(0, .1, (64, 32)) for c in centers]).astype(np.float32)
    lab8, c8 = sharded_ops.sharded_kmeans(_mesh(8), pts, 4)
    lab1, c1 = sharded_ops.sharded_kmeans(_mesh(1), pts, 4)
    np.testing.assert_array_equal(lab8, lab1)
    np.testing.assert_allclose(c8, c1, rtol=1e-5, atol=1e-5)
    for g in range(4):
        assert len(np.unique(lab8[g * 64:(g + 1) * 64])) == 1


def test_sharded_nearest_matches_single():
    """Queries sharded, K1's plain version per shard: the 1-shard result
    bit for bit, and the JAX package's sharded 1-NN within its test's
    tolerance."""
    rng = np.random.default_rng(SEED)
    q = rng.normal(0, 1, (300, 64)).astype(np.float32)
    c = rng.normal(0, 1, (900, 64)).astype(np.float32)
    idx8, err8 = sharded_ops.sharded_nearest_1(_mesh(8), q, c)
    idx1, err1 = nn_kernels.nearest_1(torch.from_numpy(q),
                                      torch.from_numpy(c))
    np.testing.assert_array_equal(idx8, idx1.numpy())
    np.testing.assert_array_equal(err8, err1.numpy())
    jidx, _ = jsharded.sharded_nearest_1(jmesh.make_mesh(8), q, c)
    d8 = ((q - c[idx8]) ** 2).sum(1)
    dj = ((q - c[np.asarray(jidx)]) ** 2).sum(1)
    np.testing.assert_allclose(d8, dj, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('n_dev', [1, 2, 8])
def test_sharded_kmodes_matches_single_device(n_dev):
    """Sharded KModes (integer category counts summed across shards)
    equals the JAX package's single-device solver bit for bit, labels
    and centroids."""
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 16, (403, 80)).astype(np.uint8)
    x[:, 64:] = x[:, 64:] & 1
    k, start = 23, 7
    want_labels, want_cents = jkmodes.kmodes(x, k, start, n_modalities=16)
    got_labels, got_cents = sharded_ops.sharded_kmodes(
        _mesh(n_dev), x, k, start, n_modalities=16)
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_array_equal(got_cents, want_cents)


@pytest.mark.parametrize('n_dev', [2, 8])
def test_sharded_kmodes_batch_matches_one_device(n_dev):
    """Restart lanes and several bins in one sharded solve: labels,
    centroids and winners of the 1-device batch solver."""
    rng = np.random.default_rng(SEED)
    tiles = rng.integers(0, 16, (400, 8, 8)).astype(np.uint8)
    tiles[200:260] = tiles[0:60]
    sigs = torch.from_numpy(jgt.tile_signatures(tiles, 16))
    sels = [np.arange(0, 150), np.arange(150, 320), np.arange(320, 400)]
    args = (sels, [12, 20, 7], [-3, 5, -2], 16)
    want = kmodes.kmodes_batch_gather(sigs, *args, need_cents=True)
    got = sharded_ops.sharded_kmodes_batch(_mesh(n_dev), sigs, *args,
                                           need_cents=True)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('n_dev', [1, 2, 8])
def test_sharded_unique_matches_host(n_dev):
    """The hash-partitioned MakeUnique gives the CANONICAL winner map of
    the JAX package's host dedup at every shard count: duplicates, an
    all-0xFF row, zeros, and inactive rows that join no group."""
    rng = np.random.default_rng(SEED)
    n = 700
    tiles = rng.integers(0, 16, (n, 8, 8)).astype(np.uint8)
    tiles[50] = tiles[10]
    tiles[51] = tiles[10]
    tiles[600] = tiles[599]
    tiles[42] = 0xFF
    tiles[43] = 0xFF
    tiles[44] = 0
    active = np.ones(n, bool)
    active[::13] = False
    use = rng.integers(1, 5, n).astype(np.int64)
    fwd_want, _, _, _ = jcuf(tiles, active, use)
    sidx, winner = sharded_ops.sharded_unique(
        _mesh(n_dev), torch.from_numpy(tiles), np.flatnonzero(active), n)
    fwd_got = np.arange(n)
    fwd_got[sidx] = winner
    np.testing.assert_array_equal(fwd_got, fwd_want)


def test_hash_words_is_the_jax_packages():
    rng = np.random.default_rng(SEED)
    words = rng.integers(0, 1 << 32, (1000, 16), dtype=np.uint64)
    want = np.asarray(jsharded._hash_words(jnp.asarray(words, jnp.uint32)))
    got = sharded_ops._hash_words(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_launch_counters_lose_no_update_across_threads(monkeypatch):
    """Host threads that share a card update the kernel launch counters
    concurrently (gop_exact): no increment is lost."""
    monkeypatch.setattr(nn_kernels, 'LAUNCHES', 0)

    def launch_many():
        for _ in range(2000):
            nn_kernels._count('LAUNCHES', 1)
    threads = [threading.Thread(target=launch_many) for _ in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert nn_kernels.LAUNCHES == 16 * 2000


# -- f1: the exact GOP-sharded encode --------------------------------------------

def test_single_host_stream_is_the_jax_packages(scenes):
    assert scenes['n_kf'] >= 3, 'clip must split into >=3 GOPs'
    assert scenes['blob'] == scenes['jblob']


@pytest.mark.parametrize('n_hosts', [1, 2, 3])
def test_exact_gop_sharded_matches_single_host(scenes, n_hosts):
    """An N-host GOP-sharded encode with the cross-host tileset
    collectives writes the 1-host encoder's bytes (and so tiler_tpu's)."""
    got = gop_exact.encode_gop_sharded_exact(
        scenes['frames'], EncoderConfig(palette_count=8, max_tiles=300),
        n_hosts=n_hosts, fps=24.0, fast_lzma=True, device='cpu')
    assert got == scenes['blob'], f'{n_hosts}-host stream differs'


def test_exact_gop_sharded_with_device_sharded_kmodes(two_scenes):
    """GOPs across host threads x KModes across an 8-shard mesh."""
    frames, want = two_scenes
    got = gop_exact.encode_gop_sharded_exact(
        frames, EncoderConfig(palette_count=8, max_tiles=200), n_hosts=2,
        fps=24.0, fast_lzma=True, kmodes_mesh=_mesh(8), device='cpu')
    assert got == want


def test_worker_exception_aborts_the_barrier(two_scenes, monkeypatch):
    """A host that fails breaks the barrier for the others, and the
    failure itself is raised, within a bounded time."""
    calls = []
    lock = threading.Lock()
    real = gop_exact.run_dither

    def flaky(state):
        with lock:
            calls.append(1)
            second = len(calls) == 2
        if second:
            raise RuntimeError('host failed in dither')
        return real(state)
    monkeypatch.setattr(gop_exact, 'run_dither', flaky)
    out = {}

    def run():
        try:
            gop_exact.encode_gop_sharded_exact(
                two_scenes[0], EncoderConfig(palette_count=8, max_tiles=200),
                n_hosts=2, fast_lzma=True, device='cpu')
        except Exception as e:  # noqa: BLE001
            out['error'] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), 'the encode hung after a host failed'
    assert isinstance(out.get('error'), RuntimeError)
    assert 'host failed in dither' in str(out['error'])


def test_thread_comm_times_out():
    """A host that never reaches the gather breaks it after the timeout."""
    comm = gop_exact.ThreadComm(2, timeout=0.2)
    with pytest.raises(threading.BrokenBarrierError):
        comm.allgather(0, 'only host 0 came')


# -- f4: the mesh in the pipeline ----------------------------------------------

def test_single_device_stream_is_the_jax_packages(dryrun):
    assert dryrun['blob'] == dryrun['jblob']
    assert len(dryrun['enc'].state.keyframes) >= 2


@pytest.mark.parametrize('n_dev', [2, 4, 8])
@pytest.mark.parametrize('mesh_kmodes', [True, False])
def test_mesh_encode_byte_identical(dryrun, n_dev, mesh_kmodes):
    """The full encode with the mesh wired into every sharded stage (and
    the KModes solves with mesh_kmodes) writes the 1-device bytes, and
    so tiler_tpu's. The clip has a static band (the forward-fill path)
    and two keyframes (per-keyframe candidate sets)."""
    cfg = EncoderConfig(mesh_kmodes=mesh_kmodes, **MESH_CFG)
    enc = Encoder(cfg, device='cpu', mesh=_mesh(n_dev))
    got = enc.run_all(dryrun['frames'], fast_lzma=True)
    assert got == dryrun['blob'], 'mesh encode differs from 1 device'
    m = enc.state.metrics
    assert len(enc.state.keyframes) >= 2
    assert m['ft_q_changed_frac'] < 1.0
    assert len(m['ft_nn_calls_shards']) == n_dev
    assert sum(m['ft_nn_calls_shards']) == m['ft_nn_calls']
    assert m['mesh_sharded_wall']['measured_on_mesh']
    assert m['mesh_sharded_wall']['mesh_kmodes'] == mesh_kmodes


def test_ft_row_budget_grouping_byte_identical(dryrun, monkeypatch):
    """The port's FrameTiling row budgets (combos per stage-2 feature
    pass, queries per stage-3 kernel call, queries per stage-1 k-NN
    chunk) cut to a few rows each: the same stream, on one device and on
    a mesh, so no stage's result depends on how many rows a matmul got."""
    from tiler_tpu_torch.ops import knn
    monkeypatch.setattr(frame_tiling, '_FEAT_CHUNK', 7)
    monkeypatch.setattr(nn_kernels, 'full_chunk', lambda device: 5)
    real = knn.nearest_k_keepmask
    monkeypatch.setattr(knn, 'nearest_k_keepmask',
                        lambda q, c, k: real(q, c, k, q_chunk=3, c_chunk=11))
    cfg = EncoderConfig(**MESH_CFG)
    for mesh in (None, _mesh(4)):
        enc = Encoder(cfg, device='cpu', mesh=mesh)
        assert enc.run_all(dryrun['frames'], fast_lzma=True) == \
            dryrun['blob']
        assert enc.state.metrics['ft_nn_calls'] > 20


# the port's phase spans that the JAX package does not clock
PORT_PHASES = {'dither_phases': {'features', 'kmeans_pp', 'lloyd',
                                 'mirrors'},
               'ft_phases': {'prepare', 'search', 'cand_set'}}


def test_metric_keys_are_the_jax_packages(dryrun):
    """run_all's metric keys (and those of the phase dicts and of the
    per-step round trips) are tiler_tpu's, but for its upload counter, and
    the port's counts of stage-3 kernel calls and of stage-2 feature
    rows, Save's phases and the phases it clocks inside Dither and
    FrameTiling."""
    mine, theirs = dryrun['enc'].state.metrics, dryrun['jmetrics']
    assert set(mine) - {'ft_nn_calls', 'ft_feat_rows', 'save_phases'} == \
        set(theirs) - {'upload_changed_frac'}
    for key in ('mu_phases', 'gt_phases', 'mesh_sharded_wall',
                'dither_phases', 'ft_phases', 'dispatches'):
        added = PORT_PHASES.get(key, set())
        assert added <= set(mine[key]), key
        assert set(mine[key]) - added == set(theirs[key]), key
    assert mine['gt_phases']['gt_mu'] == mine['mu_phases']
    assert not mine['mesh_sharded_wall']['measured_on_mesh']


# -- f5: the mesh's entry points -------------------------------------------------

def test_streaming_with_a_mesh_writes_the_same_file(two_scenes, tmp_path):
    frames, _ = two_scenes
    cfg = EncoderConfig(palette_count=8, max_tiles=200)
    files = []
    for mesh in (None, _mesh(4)):
        path = str(tmp_path / f'{mesh is None}.gtm')
        m = stream.encode_streaming(iter(frames), cfg, path, fps=24.0,
                                    fast_lzma=True, chunk=3, device='cpu',
                                    mesh=mesh)
        assert m['n_keyframes'] == 2
        files.append(open(path, 'rb').read())
    assert files[0] == files[1]


@pytest.fixture(scope='module')
def clip_file(tmp_path_factory, two_scenes):
    d = tmp_path_factory.mktemp('par')
    np.save(d / 'clip.npy', two_scenes[0])
    return d


CLI_ENC = ['--device', 'cpu', '--palette-count', '8', '--max-tiles', '200',
           '--fast-lzma', '--fps', '24.0']


@pytest.mark.parametrize('flags', [['--devices', '4'],
                                   ['--devices', '2', '--mesh-kmodes'],
                                   ['--hosts', '3'],
                                   ['--stream', '--devices', '8']])
def test_cli_multi_device_forms_write_the_single_device_bytes(
        clip_file, two_scenes, capsys, flags):
    out = str(clip_file / ('_'.join(flags) + '.gtm'))
    assert cli.main(['encode', str(clip_file / 'clip.npy'), out]
                    + CLI_ENC + flags) == 0
    got = open(out, 'rb').read()
    if '--stream' in flags:
        assert cli.main(['encode', str(clip_file / 'clip.npy'), out + '.1',
                         '--stream'] + CLI_ENC) == 0
        assert got == open(out + '.1', 'rb').read()
    else:
        assert got == two_scenes[1]
    if '--hosts' in flags:
        m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert m == dict(hosts=3, gtm_bytes=len(got), exact=True)


def test_cli_devices_must_be_a_power_of_two(clip_file):
    with pytest.raises(SystemExit, match='power of two'):
        cli.main(['encode', str(clip_file / 'clip.npy'),
                  str(clip_file / 'x.gtm'), '--devices', '3'] + CLI_ENC)
    assert not (clip_file / 'x.gtm').exists()


# -- f6: the multi-process form ------------------------------------------------

def test_init_distributed_without_a_coordinator_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv('TILER_COORDINATOR', raising=False)
    pdist.init_distributed()
    assert not dist.is_initialized()
    comm = gop_exact.ProcessComm()
    assert (comm.rank, comm.n_hosts) == (0, 1)
    assert comm.allgather(0, {'a': 1}) == [{'a': 1}]


def test_distributed_two_process_encode(clip_file, two_scenes):
    """Two CLI processes joined by torch.distributed (gloo, a free
    localhost port) write the one-process bytes; rank 0 writes."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    out = clip_file / 'dist.gtm'
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    procs = []
    for pid in (0, 1):
        target = str(out) if pid == 0 else os.devnull
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'tiler_tpu_torch', 'encode',
             str(clip_file / 'clip.npy'), target] + CLI_ENC +
            ['--distributed', '--coordinator', f'localhost:{port}',
             '--num-processes', '2', '--process-id', str(pid)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-2000:]
    m = json.loads(results[0][0].strip().splitlines()[-1])
    assert m == dict(processes=2, gtm_bytes=len(two_scenes[1]))
    assert out.read_bytes() == two_scenes[1]


# -- ROADMAP Queue 3: the restored arguments -----------------------------------

def test_run_global_tiling_gts_out_and_budget(dryrun, tmp_path):
    """run_global_tiling(state, desired_tiles, gts_out) as tiler_tpu's:
    the GTS file bytes equal, and a budget below the default gives the
    reference's tile count."""
    cfg = dict(MESH_CFG, end_step='make_unique')
    states = []
    for desired in (None, 40):
        jenc = JaxEncoder(JaxConfig(**cfg))
        jenc.run_all(dryrun['frames'])
        enc = Encoder(EncoderConfig(**cfg), device='cpu')
        enc.run_all(dryrun['frames'])
        mine, theirs = str(tmp_path / 'p.gts'), str(tmp_path / 'j.gts')
        run_global_tiling(enc.state, desired_tiles=desired, gts_out=mine)
        jgt.run_global_tiling(jenc.state, desired_tiles=desired,
                              gts_out=theirs)
        assert open(mine, 'rb').read() == open(theirs, 'rb').read()
        n = int(enc.state.tile_active.sum())
        assert n == int(jenc.state.tile_active.sum())
        states.append(n)
    assert states[1] < states[0]


def test_kmeans_core_max_iters_and_seed_are_the_jax_packages():
    rng = np.random.default_rng(SEED)
    x = np.concatenate([rng.normal(c, 1.0, (40, 24)) for c in (0, 6, 12)]
                       ).astype(np.float32)
    for kw in (dict(max_iters=1), dict(seed=7), dict(max_iters=3, seed=9)):
        jl, jc, jit = jax.jit(jkmeans.kmeans_core,
                              static_argnames=('k', 'max_iters'))(
            jnp.asarray(x), k=5, **kw)
        tl, tc, tit = kmeans_core(torch.from_numpy(x), 5, **kw)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)
        assert tit == int(jit)


def test_kmodes_batch_gather_max_iters_is_the_jax_packages():
    rng = np.random.default_rng(SEED)
    tiles = rng.integers(0, 16, (300, 8, 8)).astype(np.uint8)
    sigs = jgt.tile_signatures(tiles, 16)
    sels, ks, starts = [np.arange(0, 140), np.arange(140, 300)], [9, 14], \
        [3, -2]
    for it in (0, 1, 2):
        want = jkmodes.kmodes_batch_gather(
            jnp.asarray(sigs), [s.astype(np.int32) for s in sels], ks,
            starts, 16, max_iters=it)
        iters = []
        got = kmodes.kmodes_batch_gather(torch.from_numpy(sigs), sels, ks,
                                         starts, 16, max_iters=it,
                                         iters_out=iters)
        assert max(i for _, _, i in iters) <= it
        for (jl, _jc, jw), (tl, tw) in zip(want, got):
            np.testing.assert_array_equal(tl, np.asarray(jl, np.int64))
            np.testing.assert_array_equal(tw, np.asarray(jw))


@pytest.mark.parametrize('kw', [dict(q_weighting=True),
                                dict(use_lab=True, q_weighting=True),
                                dict(use_wavelets=True, mirrored=True),
                                dict(q_weighting=True, mirrored=True)])
def test_psyv_features_rgb_arguments_are_the_jax_packages(kw):
    rng = np.random.default_rng(SEED)
    tiles = rng.integers(0, 256, (300, 8, 8, 3)).astype(np.uint8)
    kw = dict(kw)
    if kw.pop('mirrored', False):
        kw['hmir'] = rng.random(300) < 0.5
        kw['vmir'] = rng.random(300) < 0.5
    want = np.asarray(jfeatures.psyv_features_rgb(tiles, **kw))
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = features.psyv_features_rgb(torch.from_numpy(tiles), **tkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def test_encoder_takes_the_mesh_and_never_saves_it(tmp_path):
    """A mesh must be of the device the encode was asked for: a CPU mesh
    under the default device 'cuda' (or a CUDA mesh under 'cpu') raises
    instead of running elsewhere. The mesh is not saved: a loaded state
    carries the 1-shard mesh of its device."""
    from tiler_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    cfg = EncoderConfig(end_step='load', **MESH_CFG)
    mesh = _mesh(2)
    with pytest.raises((RuntimeError, ValueError), match='cuda'):
        Encoder(cfg, mesh=mesh)
    cuda_mesh = make_mesh(devices=['cuda'] * 2)
    with pytest.raises(ValueError, match='asked to run on cpu'):
        Encoder(cfg, device='cpu', mesh=cuda_mesh)
    with pytest.raises(ValueError, match='asked to run on cpu'):
        gop_exact.encode_gop_sharded_exact(
            _dryrun_clip(), cfg, kmodes_mesh=cuda_mesh, device='cpu')
    assert Encoder(cfg, device='cpu').state.mesh.flat == \
        [torch.device('cpu')]
    enc = Encoder(cfg, device='cpu', mesh=mesh)
    assert enc.device == torch.device('cpu') and enc.state.mesh is mesh
    enc.run_all(_dryrun_clip())
    save_checkpoint(str(tmp_path / 'ck'), enc.state)
    loaded = load_checkpoint(str(tmp_path / 'ck'), 'cpu')
    assert loaded.mesh is not mesh and loaded.mesh.size == 1
