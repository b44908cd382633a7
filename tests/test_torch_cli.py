"""The port's command line, verb by verb, through main([...]) in process
with --device cpu (one subprocess case for the injected crash): what it
prints and writes is held against the JAX package's CLI on the same
files. Every comparison is exact."""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tiler_tpu import __main__ as jcli
from tiler_tpu_torch import __main__ as cli
from tiler_tpu_torch.decode import decode_video
from tiler_tpu_torch.tools.common import synthetic_clip_v2

# the shapes here are tiny and several test processes share the cores:
# one thread each keeps them from spinning on each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = ['--device', 'cpu', '--palette-count', '8', '--max-tiles', '100',
       '--fast-lzma']


def _last_json(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith('{')][-1])


@pytest.fixture(scope='module')
def work(tmp_path_factory):
    """A clip, its stream from an uninterrupted CLI encode, and a
    checkpoint of the finished state."""
    d = tmp_path_factory.mktemp('cli')
    np.save(d / 'clip.npy', synthetic_clip_v2(8, 64, 96, seed=1))
    rc = cli.main(['encode', str(d / 'clip.npy'), str(d / 'ref.gtm'),
                   '--checkpoint', str(d / 'state')] + ENC)
    assert rc == 0 and (d / 'state.npz').exists()
    return d


def test_encode_prints_metrics_with_psnr(work, capsys):
    out = str(work / 'again.gtm')
    assert cli.main(['encode', str(work / 'clip.npy'), out] + ENC) == 0
    stdout = capsys.readouterr().out
    m = _last_json(stdout)
    assert m['device'] == 'cpu' and m['n_keyframes'] == 3
    assert m['gtm_bytes'] == os.path.getsize(out)
    blob = open(out, 'rb').read()
    assert blob == (work / 'ref.gtm').read_bytes()
    from tiler_tpu_torch.ops.stats import psnr
    want = psnr(decode_video(blob)[0], np.load(work / 'clip.npy'))
    assert m['psnr'] == round(want, 3)
    assert list(m['step_times']) == ['load', 'dither', 'make_unique',
                                     'global_tiling', 'frame_tiling',
                                     'reindex', 'smooth', 'save']
    assert stdout.count('Step: ') == 8


@pytest.mark.parametrize('flags', [
    [], ['--start-frame', '3', '--frame-count', '7', '--scaling', '0.5'],
    ['--start-step', 'dither', '--end-step', 'smooth', '--fps', '30',
     '--lzma-mode', 'lc8'],
    ['--qb-tiles', '1.5', '--ft-quality', 'slow', '--smoothing', '5',
     '--palette-size', '32']])
def test_encode_flags_and_config_are_the_jax_clis(flags):
    jp = argparse.ArgumentParser()
    jcli._add_encode_flags(jp)
    pp = argparse.ArgumentParser()
    cli._add_encode_flags(pp)
    ja, pa = vars(jp.parse_args(flags)), vars(pp.parse_args(flags))
    assert pa.pop('device') == 'cuda'
    assert pa == ja
    want = jcli._config_from_args(jp.parse_args(flags))
    got = cli._config_from_args(pp.parse_args(flags))
    assert type(got) is not type(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_verbs_are_the_jax_clis():
    def verbs(parser):
        sub = [a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction)][0]
        return {name: sorted(o for a in p._actions for o in a.option_strings
                             if o not in ('--device', '-h', '--help'))
                for name, p in sub.choices.items()}
    got = verbs(cli.build_parser())
    assert set(got) == {'encode', 'decode', 'transcode', 'info', 'serve',
                        'preview', 'debug'}
    # the JAX CLI builds its parser inside main(): every option of the
    # port's verbs is one its source declares
    jsrc = open(jcli.__file__).read()
    for name, opts in got.items():
        for o in opts:
            assert repr(o) in jsrc, (name, o)
    assert cli._pattern_to_glob('in_%04d.png') == \
        jcli._pattern_to_glob('in_%04d.png') == 'in_*.png'
    assert cli._pattern_to_glob('a%d.png') == 'a*.png'
    assert cli._pattern_to_glob('plain.png') == 'plain.png'


def test_info_prints_what_the_jax_cli_prints(work, capsys):
    for path in (str(work / 'ref.gtm'),
                 os.path.join(REPO, 'decoders', 'web', 'sample.gtm')):
        assert cli.main(['info', path]) == 0
        mine = capsys.readouterr().out
        assert jcli.main(['info', path]) == 0
        assert mine == capsys.readouterr().out
        assert json.loads(mine)['frames'] > 0


@pytest.mark.parametrize('mode', ['lc3', 'lc8'])
def test_transcode_writes_what_the_jax_cli_writes(work, capsys, mode):
    src = str(work / 'ref.gtm')
    a, b = str(work / f'p_{mode}.gtm'), str(work / f'j_{mode}.gtm')
    assert cli.main(['transcode', src, a, '--lzma-mode', mode]) == 0
    mine = capsys.readouterr().out
    assert jcli.main(['transcode', src, b, '--lzma-mode', mode]) == 0
    assert mine == capsys.readouterr().out
    blob = open(a, 'rb').read()
    assert blob == open(b, 'rb').read()
    assert json.loads(mine)['output_bytes'] == len(blob)
    np.testing.assert_array_equal(decode_video(blob)[0],
                                  decode_video(open(src, 'rb').read())[0])


def test_transcode_names_the_bad_file(work, tmp_path):
    blob = (work / 'ref.gtm').read_bytes()
    bad = tmp_path / 'bad.gtm'
    bad.write_bytes(blob[:len(blob) // 2])
    said = []
    for main in (cli.main, jcli.main):
        with pytest.raises(ValueError, match='bad.gtm: ') as e:
            main(['transcode', str(bad), str(tmp_path / 'o.gtm')])
        said.append(str(e.value))
    assert said[0] == said[1] and not (tmp_path / 'o.gtm').exists()


def test_debug_prints_what_the_jax_cli_prints(capsys):
    assert cli.main(['debug', '--device', 'cpu']) == 0
    mine = capsys.readouterr().out.splitlines()
    assert jcli.main(['debug']) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert len(mine) == len(theirs) == 71
    for a, b in zip(mine, theirs):
        assert a == b
    assert mine[0].startswith('palette: [') and 'hsv roundtrip' in mine[5]


def test_preview_pngs_equal_the_jax_clis(work, capsys):
    from PIL import Image
    ck = str(work / 'state.npz')
    a, b = work / 'pv_port', work / 'pv_jax'
    flags = ['--frame', '5', '--page', '0', '--palette', '3']
    assert cli.main(['preview', ck, str(a), '--device', 'cpu'] + flags) == 0
    mine = json.loads(capsys.readouterr().out)
    assert jcli.main(['preview', ck, str(b)] + flags) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert abs(mine.pop('correlation') - theirs.pop('correlation')) < 1e-5
    assert mine == theirs and set(mine) == {'source', 'output', 'tiles',
                                            'palette'}
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == sorted(
        mine.values())
    for name in mine.values():
        np.testing.assert_array_equal(np.asarray(Image.open(a / name)),
                                      np.asarray(Image.open(b / name)))
    out = np.asarray(Image.open(a / 'output_5.png'))
    dec, _ = decode_video((work / 'ref.gtm').read_bytes())
    np.testing.assert_array_equal(out, dec[5])
    # a subset of the views
    assert cli.main(['preview', ck, str(work / 'pv_one'), '--device', 'cpu',
                     '--views', 'palette']) == 0
    assert os.listdir(work / 'pv_one') == ['palette.png']


def test_serve_stages_the_demo_page_and_the_stream(work, capsys,
                                                   monkeypatch):
    import http.server
    seen = {}

    class FakeServer:
        def __init__(self, addr, handler):
            seen['addr'] = addr
            seen['dir'] = handler.keywords['directory']

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def serve_forever(self):
            seen['staged'] = {
                f: open(os.path.join(seen['dir'], f), 'rb').read()
                for f in os.listdir(seen['dir'])}
            raise KeyboardInterrupt

    monkeypatch.setattr(http.server, 'ThreadingHTTPServer', FakeServer)
    src = str(work / 'ref.gtm')
    assert cli.main(['serve', src, '--port', '8765']) == 0
    assert seen['addr'] == ('127.0.0.1', 8765)
    web = os.path.join(REPO, 'decoders', 'web')
    assert seen['staged'] == {
        'index.html': open(os.path.join(web, 'index.html'), 'rb').read(),
        'gtm_player.js': open(os.path.join(web, 'gtm_player.js'),
                              'rb').read(),
        'stream.gtm': open(src, 'rb').read()}
    assert not os.path.exists(seen['dir'])     # removed after serving
    assert 'index.html?url=stream.gtm' in capsys.readouterr().out


@pytest.mark.parametrize('flags,name', [
    (['--devices', '2'], '--devices 2'),
    (['--mesh-kmodes'], '--mesh-kmodes'),
    (['--hosts', '2'], '--hosts 2 without --gop-local-tilesets'),
    (['--distributed', '--coordinator', 'h:1', '--num-processes', '2',
      '--process-id', '0'], '--distributed'),
    (['--stream', '--devices', '4'], '--devices 4'),
    (['--device', 'cuda', '--hosts', '3'], '--hosts 3 without')])
def test_multi_device_flags_exit_2_by_name(work, capsys, flags, name):
    """The multi-device flags run now: each writes the stream of the
    single-device encode (the streaming file with --stream). The
    --distributed case joins a one-process job on a free localhost port
    in place of its unreachable coordinator. Only a missing device still
    exits 2, by its name: --device cuda without a card."""
    out = work / 'multi.gtm'
    if out.exists():
        out.unlink()
    if '--distributed' in flags:
        import socket
        with socket.socket() as s:
            s.bind(('localhost', 0))
            port = s.getsockname()[1]
        flags = flags[:1] + ['--coordinator', f'localhost:{port}',
                             '--num-processes', '1', '--process-id', '0']
    rc = cli.main(['encode', str(work / 'clip.npy'), str(out)] + ENC + flags)
    err = capsys.readouterr().err
    if '--device' in flags and not torch.cuda.is_available():
        assert rc == 2 and not out.exists()
        assert err.count('\n') == 1 and 'cuda' in err
        assert '--device cpu' in err
        return
    assert rc == 0 and 'multi-device port is not done' not in err
    want = work / ('s.gtm' if '--stream' in flags else 'ref.gtm')
    if not want.exists():
        assert cli.main(['encode', str(work / 'clip.npy'), str(want),
                         '--stream'] + ENC) == 0
    assert out.read_bytes() == want.read_bytes(), name


@pytest.mark.parametrize('device,n,cards,said', [
    ('cuda', 2, 0, '--devices 2: 2 devices asked for: only 0 device(s) '
     'available'),
    ('cuda', 4, 2, '--devices 4: 4 devices asked for: only 2 device(s) '
     'available'),
    ('cuda', 3, 4, '--devices 3: device count must be a power of two'),
    ('cuda', 2, 4, None),
    ('cuda', 1, 0, None),
    ('cpu', 2, 0, None),
    ('cpu', 3, 0, '--devices 3: device count must be a power of two')])
def test_mesh_from_args(monkeypatch, device, n, cards, said):
    """--devices N: a mesh of the first N cards (N logical CPU shards with
    --device cpu), None for one device, and never a silent fallback: too
    few cards, or N not a power of two, exits by name. Cards are counted,
    never touched, so none is needed."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    a = cli.build_parser().parse_args(
        ['encode', 'in.npy', 'out.gtm', '--device', device, '--devices',
         str(n)])
    if said:
        with pytest.raises(SystemExit) as e:
            cli._mesh_from_args(a)
        assert e.value.code == said
    elif n == 1:
        assert cli._mesh_from_args(a) is None
    else:
        want = [torch.device(device, i if device == 'cuda' else None)
                for i in range(n)]
        assert cli._mesh_from_args(a).flat == want


@pytest.mark.parametrize('argv', [
    ['encode', 'clip.npy', 'o.gtm'], ['encode', 'clip.npy', 'o.gtm',
                                      '--stream'],
    ['encode', 'clip.npy', 'o.gtm', '--hosts', '2', '--gop-local-tilesets'],
    ['preview', 'state.npz', 'pv'], ['debug']])
def test_device_verbs_default_to_cuda_and_exit_2_without_a_card(
        work, capsys, monkeypatch, argv):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    monkeypatch.chdir(work)
    assert cli.main(argv) == 2
    cap = capsys.readouterr()
    assert 'cuda' in cap.err and '--device cpu' in cap.err and not cap.out
    assert not (work / 'o.gtm').exists() and not (work / 'pv').exists()


def test_png_pattern_in_and_pngs_out(work, capsys):
    from PIL import Image
    frames = np.load(work / 'clip.npy')
    src = work / 'png_in'
    src.mkdir()
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(src / f'in_{i:04d}.png')
    out = str(work / 'png.gtm')
    assert cli.main(['encode', str(src / 'in_%04d.png'), out] + ENC) == 0
    assert open(out, 'rb').read() == (work / 'ref.gtm').read_bytes()
    dst = work / 'png_out'
    dst.mkdir()
    capsys.readouterr()
    assert cli.main(['decode', out, str(dst / 'o_%03d.png')]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info == dict(frames=8, width=96, height=64, tiles=info['tiles'])
    dec, _ = decode_video(open(out, 'rb').read())
    assert sorted(os.listdir(dst)) == [f'o_{i:03d}.png' for i in range(8)]
    for i in range(8):
        np.testing.assert_array_equal(
            np.asarray(Image.open(dst / f'o_{i:03d}.png')), dec[i])
    # a plain prefix gets numbered names; .npy gets the array
    assert cli.main(['decode', out, str(dst / 'plain')]) == 0
    assert (dst / 'plain.0007.png').exists()
    assert cli.main(['decode', out, str(dst / 'all.npy')]) == 0
    np.testing.assert_array_equal(np.load(dst / 'all.npy'), dec)
    # the streaming encode reads the same pattern one file at a time
    s1, s2 = str(work / 'png_s.gtm'), str(work / 'npy_s.gtm')
    assert cli.main(['encode', str(src / 'in_%04d.png'), s1, '--stream']
                    + ENC) == 0
    assert cli.main(['encode', str(work / 'clip.npy'), s2, '--stream']
                    + ENC) == 0
    assert open(s1, 'rb').read() == open(s2, 'rb').read()


def test_stream_and_hosts_write_the_same_file(work, capsys):
    s, h = str(work / 's.gtm'), str(work / 'h.gtm')
    assert cli.main(['encode', str(work / 'clip.npy'), s, '--stream']
                    + ENC) == 0
    m = _last_json(capsys.readouterr().out)
    assert m['n_frames'] == 8 and m['n_keyframes'] == 3
    assert m['gtm_bytes'] == os.path.getsize(s)
    assert cli.main(['encode', str(work / 'clip.npy'), h, '--hosts', '2',
                     '--gop-local-tilesets'] + ENC) == 0
    hm = _last_json(capsys.readouterr().out)
    assert hm == dict(hosts=2, gtm_bytes=m['gtm_bytes'], exact=False)
    assert open(s, 'rb').read() == open(h, 'rb').read()
    assert decode_video(open(s, 'rb').read())[0].shape == (8, 64, 96, 3)


def test_checkpoint_then_resume_at_a_later_step(work, capsys):
    ck = str(work / 'mid')
    clip = str(work / 'clip.npy')
    part = work / 'part.gtm'
    assert cli.main(['encode', clip, str(part), '--end-step',
                     'global_tiling', '--checkpoint', ck] + ENC) == 0
    assert not part.exists()                   # no save step, no stream
    m = _last_json(capsys.readouterr().out)
    assert 'psnr' in m and 'save' not in m['step_times']
    out = str(work / 'resumed.gtm')
    assert cli.main(['encode', 'ignored.npy', out, '--resume', ck,
                     '--start-step', 'frame_tiling'] + ENC) == 0
    stdout = capsys.readouterr().out
    assert 'Step: frame_tiling' in stdout and 'Step: dither' not in stdout
    assert open(out, 'rb').read() == (work / 'ref.gtm').read_bytes()


def test_injected_crash_exits_13_and_the_rerun_resumes(work):
    ck = work / 'auto'
    out = work / 'crash.gtm'
    argv = [sys.executable, '-m', 'tiler_tpu_torch', 'encode',
            str(work / 'clip.npy'), str(out), '--auto-checkpoint',
            str(ck)] + ENC
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               TILER_CRASH_AFTER_STEP='global_tiling')
    r = subprocess.run(argv, capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=600)
    assert r.returncode == 13, r.stderr[-2000:]
    assert "injected crash after 'global_tiling'" in r.stdout
    assert (work / 'auto.npz').exists() and not out.exists()
    assert [f for f in os.listdir(work) if '.tmp.' in f] == []
    # the rerun, in process, picks up at the next step
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv[3:]) == 0
    text = buf.getvalue()
    assert "resuming at step 'frame_tiling' (completed: global_tiling)" \
        in text
    assert 'Step: dither' not in text and 'Step: save' in text
    assert not (work / 'auto.npz').exists()
    assert out.read_bytes() == (work / 'ref.gtm').read_bytes()


def test_broken_pipe_exits_quietly(work):
    """A consumer that goes away (`... | head`) ends the command with
    exit 0 and no traceback; run in a child, since the exit closes
    stdout."""
    code = ("import sys\n"
            "from tiler_tpu_torch import __main__ as cli\n"
            "def gone(a):\n"
            "    print('x' * 10)\n"
            "    raise BrokenPipeError\n"
            "cli.cmd_info = gone\n"
            f"sys.exit(cli.main(['info', {str(work / 'ref.gtm')!r}]))\n")
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=REPO, timeout=600,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and 'Traceback' not in r.stderr, r.stderr
