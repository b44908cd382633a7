"""The port stands alone: tiler_tpu_torch imports nothing of the JAX
package tiler_tpu, of its benchmark script or of jax, and every module it
keeps as its own copy gives, on the same numpy inputs made from a seed,
byte-for-byte what the original gives."""
import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

import bench
import tiler_tpu.config as jconfig
import tiler_tpu.constants as jconstants
import tiler_tpu.decode as jdecode
import tiler_tpu.native as jnative
from tiler_tpu.bitstream import gtm as jgtm
from tiler_tpu.pipeline.reindex import compute_reindex as jcompute_reindex
from tiler_tpu.utils import progress as jprogress
from tiler_tpu.utils.checkpoint import _ARRAY_FIELDS
import tiler_tpu_torch.config as pconfig
import tiler_tpu_torch.constants as pconstants
import tiler_tpu_torch.decode as pdecode
import tiler_tpu_torch.native as pnative
from tiler_tpu_torch.bitstream import gtm as pgtm
from tiler_tpu_torch.pipeline.reindex import compute_reindex
from tiler_tpu_torch.pipeline.state import ARRAY_FIELDS
from tiler_tpu_torch.tools import common
from tiler_tpu_torch.tools.common import synthetic_clip_v2
from tiler_tpu_torch.utils import progress as pprogress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'tiler_tpu', 'bench', '__graft_entry__')
_BLOCK = ("import sys\n"
          f"for m in {BLOCKED!r}: sys.modules[m] = None\n")
_NONE_LOADED = (
    f"assert not any(m.split('.')[0] in {BLOCKED!r} "
    "for m in sys.modules if sys.modules[m] is not None)\n")


def _run(code):
    # one thread: the shapes are tiny and test processes share the cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600)


# -- (a) the port with the JAX package unimportable -------------------------

def test_every_module_imports_with_jax_package_blocked():
    code = _BLOCK + (
        "import importlib, pkgutil, tiler_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "tiler_tpu_torch.__path__, 'tiler_tpu_torch.')]\n"
        "for n in names:\n"
        "    if not n.endswith('__main__'): importlib.import_module(n)\n"
        + _NONE_LOADED +
        "print(json.dumps(names))\n")
    out = _run("import json\n" + code)
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) >= 36
    assert 'tiler_tpu_torch.graft_entry' in names


def test_new_modules_are_walked_and_import_no_jax():
    """The modules of the later slice are in the package walk above, and
    PIL is not loaded by importing them (it is reached inside the
    functions that read or write PNGs)."""
    mods = ['player', 'render', 'utils.checkpoint', 'parallel.distributed',
            'pipeline.stream', 'pipeline.load', 'decode', '__main__',
            'tools.stage3_precision', 'tools.profile_encode',
            'tools.decode_bench', 'tools.common', 'graft_entry',
            'utils.dispatch']
    code = _BLOCK + (
        "import importlib\n"
        f"for n in {mods!r}:\n"
        "    importlib.import_module('tiler_tpu_torch.' + n)\n"
        + _NONE_LOADED +
        "assert 'PIL' not in sys.modules\n"
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_decode_bench_runs_with_jax_package_blocked():
    """tools.decode_bench on the web player's sample stream on the CPU
    prints its line, every renderer's frames the numpy decoder's, with
    tiler_tpu, bench, jax and __graft_entry__ unimportable."""
    sample = os.path.join(REPO, 'decoders', 'web', 'sample.gtm')
    code = _BLOCK + (
        "from tiler_tpu_torch.tools import decode_bench\n"
        f"decode_bench.main([{sample!r}, '--device', 'cpu'])\n"
        + _NONE_LOADED)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['frames'] == 48 and res['same_frames'] is True


def test_parallel_modules_run_with_jax_package_blocked():
    """Every module of the port's multi-device encoder imports, and a
    2-shard mesh encode and a 2-host exact encode run and write the
    1-device bytes, with tiler_tpu, bench, jax and __graft_entry__
    unimportable."""
    mods = ['parallel.mesh', 'parallel.sharded_ops',
            'parallel.mesh_pipeline', 'parallel.gop_exact',
            'parallel.distributed']
    code = _BLOCK + (
        "import importlib\n"
        f"for n in {mods!r}:\n"
        "    importlib.import_module('tiler_tpu_torch.' + n)\n"
        "from tiler_tpu_torch.config import EncoderConfig\n"
        "from tiler_tpu_torch.parallel.gop_exact import "
        "encode_gop_sharded_exact\n"
        "from tiler_tpu_torch.parallel.mesh import make_mesh\n"
        "from tiler_tpu_torch.pipeline.encoder import Encoder\n"
        "from tiler_tpu_torch.tools.common import synthetic_clip_v2\n"
        "clip = synthetic_clip_v2(4, 48, 64, seed=2)\n"
        "cfg = EncoderConfig(palette_count=8, max_tiles=60)\n"
        "want = Encoder(cfg, device='cpu').run_all(clip, fast_lzma=True)\n"
        "mesh = make_mesh(devices=['cpu', 'cpu'])\n"
        "assert Encoder(cfg, device='cpu', mesh=mesh).run_all(\n"
        "    clip, fast_lzma=True) == want\n"
        "assert encode_gop_sharded_exact(clip, cfg, 2, fps=24.0, "
        "fast_lzma=True, device='cpu') == want\n"
        + _NONE_LOADED +
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'ok'


def test_graft_entry_runs_with_jax_package_blocked():
    """The port's compile-check entry points on the CPU: entry's forward step
    and a 2-shard dryrun_multichip, which prints its OK line and returns
    the 1-device stream, with tiler_tpu, bench, jax and __graft_entry__
    unimportable."""
    code = _BLOCK + (
        "from tiler_tpu_torch.graft_entry import dryrun_multichip, entry\n"
        "fn, args = entry('cpu')\n"
        "idx, err = fn(*args)\n"
        "assert idx.shape == err.shape == (256,)\n"
        "blob = dryrun_multichip(2, devices=['cpu'] * 2)\n"
        + _NONE_LOADED +
        "print(len(blob))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2].startswith("dryrun_multichip OK: mesh={'gop': 1, "
                                "'frame': 2}, ")
    assert f'gtm_bytes={lines[-1]}, ' in lines[-2]


def test_stage3_tool_and_profiled_run_with_jax_package_blocked(tmp_path):
    """The stage-3 precision tool runs both of its encodes, and
    run_all(profile_dir=) writes its trace, with tiler_tpu, bench, jax and
    __graft_entry__ unimportable."""
    prof = str(tmp_path / 'prof')
    code = _BLOCK + (
        "import os\n"
        "from tiler_tpu_torch.config import EncoderConfig\n"
        "from tiler_tpu_torch.pipeline.encoder import Encoder\n"
        "from tiler_tpu_torch.tools import stage3_precision\n"
        "from tiler_tpu_torch.tools.common import synthetic_clip_v2\n"
        "res = stage3_precision.main(['--frames', '3', '--height', '32', "
        "'--width', '48', '--palettes', '4', '--device', 'cpu'])\n"
        "assert res['stage3_queries'] > 0\n"
        "Encoder(EncoderConfig(palette_count=2, tile_palette_size=4), "
        "device='cpu').run_all(synthetic_clip_v2(2, 16, 16), "
        f"profile_dir={prof!r})\n"
        f"assert len(os.listdir({prof!r})) == 1\n"
        + _NONE_LOADED +
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'ok'


def test_cli_encodes_and_decodes_with_jax_package_blocked(tmp_path):
    clip = tmp_path / 'clip.npy'
    np.save(clip, synthetic_clip_v2(4, 64, 96, seed=1))
    gtm, dec = str(tmp_path / 'o.gtm'), str(tmp_path / 'd.npy')
    code = _BLOCK + (
        "import runpy\n"
        "def cli(*argv):\n"
        "    sys.argv = ['tiler_tpu_torch', *argv]\n"
        "    try:\n"
        "        runpy.run_module('tiler_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, e.code\n"
        f"cli('encode', {str(clip)!r}, {gtm!r}, '--device', 'cpu', "
        "'--palette-count', '8', '--max-tiles', '100', '--fast-lzma')\n"
        f"cli('decode', {gtm!r}, {dec!r})\n"
        f"cli('info', {gtm!r})\n"
        f"cli('transcode', {gtm!r}, {gtm + '.lc3'!r}, '--lzma-mode', 'lc3')\n"
        f"cli('encode', {str(clip)!r}, {gtm + '.s'!r}, '--device', 'cpu', "
        "'--palette-count', '8', '--max-tiles', '100', '--fast-lzma', "
        "'--stream')\n"
        f"cli('encode', {str(clip)!r}, {gtm + '.r'!r}, '--device', 'cpu', "
        "'--palette-count', '8', '--max-tiles', '100', '--fast-lzma', "
        f"'--checkpoint', {gtm + '.ck'!r})\n"
        f"cli('preview', {gtm + '.ck'!r}, {gtm + '.pv'!r}, '--device', "
        "'cpu')\n"
        "cli('debug', '--device', 'cpu')\n"
        "from tiler_tpu_torch.decode import decode_video_torch_scan\n"
        "from tiler_tpu_torch.player import GTMPlayer\n"
        f"data = open({gtm!r}, 'rb').read()\n"
        "assert len(list(GTMPlayer(data).frames())) == 4\n"
        "assert decode_video_torch_scan(data, 'cpu').shape[0] == 4\n"
        + _NONE_LOADED)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{')]
    assert json.loads(lines[0])['psnr'] > 15
    assert json.loads(lines[1])['frames'] == 4
    assert json.loads(lines[2])['frames'] == 4          # info
    assert json.loads(lines[3])['mode'] == 'lc3'        # transcode
    assert json.loads(lines[4])['n_frames'] == 4        # encode --stream
    assert open(gtm + '.r', 'rb').read() == open(gtm, 'rb').read()
    assert 'output' in json.loads(lines[6])             # preview
    assert sorted(os.listdir(gtm + '.pv'))[0] == 'output_0.png'
    assert np.load(dec).shape == (4, 64, 96, 3)


# -- (b) the sources ---------------------------------------------------------

def test_no_source_imports_the_jax_package():
    pat = re.compile(r'^\s*(from|import)\s+(tiler_tpu(\.|\s|$)|bench\b|jax\b'
                     r'|__graft_entry__\b)', re.M)
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(os.path.join(REPO, 'tiler_tpu_torch')):
        paths += [os.path.join(root, f) for f in files if f.endswith('.py')]
    assert len(paths) > 30
    bad = [p for p in paths if pat.search(open(p).read())]
    assert not bad, bad


def test_native_library_builds_outside_both_packages():
    assert pnative.available()
    so = os.path.realpath(pnative._SO_PATH)
    assert so.startswith(os.path.join(REPO, 'build', 'tiler_tpu_torch') + os.sep)
    assert so != os.path.realpath(jnative._SO_PATH)
    assert issubclass(pnative.NoToolchainError, RuntimeError)


# -- (c) each copy against its original --------------------------------------

def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith('_') and not isinstance(v, types.ModuleType)
            and k != 'annotations'}


def test_constants_are_the_originals():
    mine, theirs = _public(pconstants), _public(jconstants)
    assert set(mine) == set(theirs)
    n_arrays = 0
    for k, want in theirs.items():
        got = mine[k]
        if isinstance(want, np.ndarray):
            n_arrays += 1
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k
        elif callable(want):
            assert inspect.getsource(got) == inspect.getsource(want), k
        else:
            assert type(got) is type(want) and got == want, k
    assert n_arrays >= 4
    for n, size in ((1, 16), (7, 16), (128, 64)):
        assert pconstants.palette_pattern(n, size).tobytes() == \
            jconstants.palette_pattern(n, size).tobytes()
    assert pconstants.equal_quality_tile_count(1e6) == \
        jconstants.equal_quality_tile_count(1e6)


def test_config_defaults_and_fields_are_the_originals():
    mine = dataclasses.fields(pconfig.EncoderConfig)
    theirs = dataclasses.fields(jconfig.EncoderConfig)
    assert [f.name for f in mine] == [f.name for f in theirs]
    assert dataclasses.asdict(pconfig.EncoderConfig()) == \
        dataclasses.asdict(jconfig.EncoderConfig())
    assert {m.name: int(m) for m in pconfig.FTQuality} == \
        {m.name: int(m) for m in jconfig.FTQuality}
    for bad in (dict(palette_count=0), dict(tile_palette_size=1),
                dict(start_step='x'), dict(lzma_mode='x')):
        for cls in (pconfig.EncoderConfig, jconfig.EncoderConfig):
            with pytest.raises(ValueError):
                cls(**bad)


def _stream_inputs(seed=0, f=5, th=4, tw=6, n_tiles=40, pal=16, n_pal=8):
    rng = np.random.default_rng(seed)
    cells = th * tw
    return dict(
        tiles=rng.integers(0, pal, (n_tiles, 8, 8)).astype(np.uint8),
        palettes=rng.integers(0, 256, (2, n_pal, pal, 3)).astype(np.uint8),
        frames=[dict(tile_idx=rng.integers(0, n_tiles, cells).astype(np.int32),
                     pal_idx=rng.integers(0, n_pal, cells).astype(np.int32),
                     hmir=rng.random(cells) < 0.5,
                     vmir=rng.random(cells) < 0.5,
                     smoothed=(rng.random(cells) < 0.4) & (i not in (0, 3)))
                for i in range(f)],
        th=th, tw=tw, pal=pal)


def _write(mod, x, **kw):
    w = mod.GTMWriter(width=x['tw'] * 8, height=x['th'] * 8, fps=24.0,
                      tiles_pal=x['tiles'], palette_size=x['pal'],
                      frame_count=len(x['frames']), kf_count=2, **kw)
    w.add_keyframe(0, 0, 2, x['palettes'][0], x['frames'][:3])
    w.add_keyframe(1, 3, 4, x['palettes'][1], x['frames'][3:])
    return w.tobytes()


@pytest.mark.parametrize('kw', [dict(fast_lzma=True, lzma_mode='auto'),
                                dict(fast_lzma=False, lzma_mode='lc8'),
                                dict(fast_lzma=False, lzma_mode='lc3')])
def test_gtm_writer_bytes_and_decoded_frames(kw):
    x = _stream_inputs()
    blob = _write(pgtm, x, **kw)
    assert blob == _write(jgtm, x, **kw)
    got, stream = pdecode.decode_video(blob)
    want, jstream = jdecode.decode_video(blob)
    assert got.shape == (5, 32, 48, 3) and got.tobytes() == want.tobytes()
    assert stream.tiles.tobytes() == jstream.tiles.tobytes()
    parsed, jparsed = pgtm.parse_gtm(blob), jgtm.parse_gtm(blob)
    assert parsed.commands == jparsed.commands
    assert dataclasses.asdict(parsed.header) == \
        dataclasses.asdict(jparsed.header)
    # the Python walk (the parser's oracle) draws the same frames
    py = pdecode.interpret_commands_py(parsed)
    for a, b in zip(py.frames, stream.frames):
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.tile_idx, b.tile_idx)


def test_gts_bytes_and_read_back(tmp_path):
    x = _stream_inputs(seed=2)
    mine, theirs = str(tmp_path / 'a.gts'), str(tmp_path / 'b.gts')
    pgtm.write_gts(mine, x['tiles'], x['pal'])
    jgtm.write_gts(theirs, x['tiles'], x['pal'])
    assert open(mine, 'rb').read() == open(theirs, 'rb').read()
    (t1, p1), (t2, p2) = pgtm.read_gts(theirs), jgtm.read_gts(mine)
    assert p1 == p2 == x['pal'] and t1.tobytes() == t2.tobytes() \
        == x['tiles'].tobytes()


def test_native_dl3_outputs():
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (5000, 3)).astype(np.uint8)
    tiles = rng.integers(0, 256, (200, 8, 8, 3)).astype(np.uint8)
    sel = rng.permutation(200)[:77]
    sums = rng.integers(0, 1 << 20, (4, 300))
    calls = [('dl3_quant', (px, 16, 7)),
             ('dl3_quant_capped', (px, 16, 7, 64)),
             ('dl3_quant_tiles_capped', (tiles, sel, 16, 7, 128)),
             ('dl3_quant_bins', (sums[0], sums[1], sums[2],
                                 1 + sums[3] // 4096, 16))]
    for name, args in calls:
        (pal, n), (jpal, jn) = getattr(pnative, name)(*args), \
            getattr(jnative, name)(*args)
        assert n == jn > 0 and pal.tobytes() == jpal.tobytes(), name


def test_native_lzma_and_dither_outputs():
    rng = np.random.default_rng(4)
    data = bytes(rng.integers(0, 8, 20000).astype(np.uint8)) + b'tail' * 99
    for kw in (dict(), dict(lc=3, optimal=False), dict(lc=0, lp=2, pb=4)):
        enc = pnative.lzma_encode_alone(data, **kw)
        assert enc == jnative.lzma_encode_alone(data, **kw)
        assert pnative.lzma_decode_alone(enc + b'xx') == \
            jnative.lzma_decode_alone(enc + b'xx') == (data, len(enc))
    two = pnative.lzma_encode_alone(b'a' * 50) + \
        pnative.lzma_encode_alone(b'b' * 70)
    assert pnative.lzma_decode_concat(two) == \
        jnative.lzma_decode_concat(two) == b'a' * 50 + b'b' * 70
    from tiler_tpu.bitstream.pylzma1 import decode_alone as jpy
    from tiler_tpu_torch.bitstream.pylzma1 import decode_alone as ppy
    small = pnative.lzma_encode_alone(data[:3000])
    assert ppy(small) == jpy(small) == (data[:3000], len(small))
    frame = rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)
    assert pnative.fs_posterize(frame, 5).tobytes() == \
        jnative.fs_posterize(frame, 5).tobytes()
    assert pnative.fs_tile(frame[:8, :8], 4).tobytes() == \
        jnative.fs_tile(frame[:8, :8], 4).tobytes()


def _own(mod):
    """The functions and classes a module defines itself."""
    return {k: v for k, v in vars(mod).items()
            if (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


# (JAX module, port module, names whose source is the original's,
#  names that differ: they take a device or use torch, and the names
#  left out: the JAX renderer, the jit and shard_map bookkeeping of the
#  multi-device modules, and their per-stage wrappers)
_JIT_CACHES = {'_evict_other_meshes', '_get_assign_full_fn',
               '_get_chunk_feats_fn', '_get_knoll_fns',
               '_get_kmeans_prepare_fn', '_get_smooth_fn', '_get_topk_fn',
               '_get_unique_count_fn', '_get_unique_dedup_fn',
               '_kmodes_solver', '_rows_to_words', '_pad_to'}
# the per-stage wrappers of the JAX package's mesh_pipeline: the port's
# call sites cut their rows with mesh_pipeline.map_rows instead
_STAGE_WRAPPERS = {'shard_rows', 'assign_sharded_full', 'chunk_feats_sharded',
                   'knoll_counts_sharded', 'knoll_assign_sharded',
                   'kmeans_prepare_sharded', 'smooth_sharded',
                   'nearest_k_sharded', 'signatures_sharded'}
_COPIES = [
    ('decode', 'decode',
     ['FrameOps', 'DecodedStream', 'interpret_commands', '_interpret_native',
      'CommandInterpreter', 'interpret_commands_py', '_blit_cells_numpy',
      '_blit_cells_blocked', 'blocks_to_image', 'decode_video'], [],
     {'make_jax_renderer', 'decode_video_jax_scan', 'decode_video_jax'}),
    ('player', 'player', ['GTMPlayer'], [], set()),
    ('render', 'render',
     ['render_frame', 'render_tiles_page', 'render_palette_strip',
      'reconstruction_correlation', 'reconstruction_psnr'], [], set()),
    ('pipeline.load', 'pipeline.load',
     ['ffmpeg_args', 'parse_ffmpeg_fps', 'frames_from_video',
      'ffmpeg_rawvideo_args', 'open_video_stream', 'sorted_frame_paths',
      'frames_from_pngs', 'split_into_tiles'],
     ['keyframes_from_correlations', 'detect_keyframes', 'run_load'], set()),
    ('pipeline.stream', 'pipeline.stream',
     ['OnlineKeyframeDetector', '_stream_driver', '_kf_info',
      'iter_frames_npy', 'iter_frames_pngs'],
     ['_encode_gop', 'encode_streaming', '_encode_streaming_reload'], set()),
    ('parallel.distributed', 'parallel.distributed',
     ['assign_gops_to_hosts'],
     ['encode_gop_sharded', 'encode_gop_partition', 'init_distributed'],
     set()),
    ('parallel.gop_exact', 'parallel.gop_exact',
     ['HostPartition', '_to_global_tiles', '_assemble_global'],
     ['ThreadComm', 'ProcessComm', '_build_partition',
      '_encode_my_partition', 'encode_gop_sharded_exact',
      'encode_multihost'], set()),
    ('parallel.mesh', 'parallel.mesh', [], ['make_mesh'], set()),
    ('parallel.sharded_ops', 'parallel.sharded_ops', [],
     ['sharded_psyv_features', 'sharded_kmeans', 'sharded_kmodes',
      'sharded_nearest_1', 'sharded_unique', '_hash_words'], _JIT_CACHES),
    ('parallel.mesh_pipeline', 'parallel.mesh_pipeline', [],
     ['mesh_ok', 'replicate'], _JIT_CACHES | _STAGE_WRAPPERS),
    ('utils.checkpoint', 'utils.checkpoint', ['checkpoint_path'],
     ['save_checkpoint', 'load_checkpoint'], set()),
]


@pytest.mark.parametrize('jname,pname,same,ported,left_out', _COPIES,
                         ids=[c[0] for c in _COPIES])
def test_copied_functions_are_the_originals(jname, pname, same, ported,
                                            left_out):
    """Host code that the port keeps as a copy has the original's source,
    name by name; what was ported (a device argument, torch) is there
    under the same name."""
    import importlib
    jmod = importlib.import_module('tiler_tpu.' + jname)
    pmod = importlib.import_module('tiler_tpu_torch.' + pname)
    theirs, mine = _own(jmod), _own(pmod)
    for name in same:
        assert inspect.getsource(mine[name]) == \
            inspect.getsource(theirs[name]), name
    for name in ported:
        assert name in mine and name in theirs, name
    # nothing of the original is missing but what the table leaves out
    missing = set(theirs) - set(mine)
    assert missing <= left_out, missing
    if jname == 'decode':
        assert {'render_step', 'decode_video_torch',
                'decode_video_torch_scan'} <= set(mine)


def test_compute_reindex_is_the_original():
    rng = np.random.default_rng(5)
    for use in (rng.integers(0, 4, 500), np.zeros(7, np.int64),
                rng.integers(1, 1000, 64)):
        (o, m), (jo, jm) = compute_reindex(use), jcompute_reindex(use)
        assert o.dtype == jo.dtype and o.tobytes() == jo.tobytes()
        assert m.dtype == jm.dtype and m.tobytes() == jm.tobytes()


def test_array_fields_are_the_checkpoint_fields():
    assert ARRAY_FIELDS == list(_ARRAY_FIELDS)


_SHAPES = [(8, 120, 160, 0), (4, 64, 96, 5), (16, 48, 40, 1)]


@pytest.mark.parametrize(
    'shape,clip', [(s, 'synthetic_clip_v2') for s in _SHAPES]
    + [(s, 'synthetic_clip') for s in _SHAPES],
    ids=[f'shape{i}' for i in range(3)]
    + [f'noise-shape{i}' for i in range(3)])
def test_synthetic_clip_v2_is_the_benchmark_clip(shape, clip):
    """Both clips of the benchmark script (cuts_v2 and the noise clip of
    the continuity entry) frame for frame."""
    f, h, w, seed = shape
    assert getattr(common, clip)(f, h, w, seed).tobytes() == \
        getattr(bench, clip)(f, h, w, seed).tobytes()


def test_dryrun_clip_is_the_original():
    import __graft_entry__
    from tiler_tpu_torch import graft_entry
    assert inspect.getsource(graft_entry._dryrun_clip) == \
        inspect.getsource(__graft_entry__._dryrun_clip)
    assert graft_entry._dryrun_clip().tobytes() == \
        __graft_entry__._dryrun_clip().tobytes()


def _gen_sample_stream():
    """tools/gen_sample_stream.py, which is no package module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'gen_sample_stream', os.path.join(REPO, 'tools',
                                          'gen_sample_stream.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('shape', [None, (160, 88, 12)],
                         ids=['default', 'small'])
def test_sample_clip_is_the_original(shape):
    """The plasma clip of the web player's sample stream: the source, and
    the frames at the tool's default 48 x 176 x 320 and at a cut."""
    gen = _gen_sample_stream()
    assert inspect.getsource(common.sample_clip) == \
        inspect.getsource(gen.sample_clip)
    args = shape or ()
    assert common.sample_clip(*args).tobytes() == \
        gen.sample_clip(*args).tobytes()


def test_step_progress_is_the_original():
    steps = ['load', 'dither', 'save']
    mine, theirs = pprogress.StepProgress(steps), jprogress.StepProgress(steps)
    for s in steps:
        mine.finish_step(s)
        theirs.finish_step(s)
        assert mine.fraction == theirs.fraction
        assert mine.format_suffix()[:4] == theirs.format_suffix()[:4]
    assert set(_public(pprogress)) == set(_public(jprogress))
