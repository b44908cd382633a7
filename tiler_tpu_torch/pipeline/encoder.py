"""Encoder orchestrator: the counterpart of tiler_tpu/pipeline/encoder.py.

Runs Load -> Dither -> MakeUnique -> GlobalTiling -> FrameTiling ->
Reindex -> Smooth -> Save with the frame-axis-parallel stages cut across
a mesh (parallel.mesh_pipeline; the same bytes at any shard count; one
device is its 1-shard mesh),
honouring the config's start/end steps, with the JAX package's
`step_times` and metric keys but for its tunnel counter
`upload_changed_frac`. Each step runs inside the span 'step:<name>'
(utils.dispatch.span: a profiler annotation and a host clock) that ends
with a device synchronize, so step_times[name] is the step's wall time
on the card and not its enqueue time; metrics['dispatches'][step] holds
the step's host<->card round trips and kernel launches (utils.dispatch),
the synchronize included. Inside a step, each phase is a span
'<step>/<key>', and the step writes the phases' seconds into its dict:
metrics['dither_phases'], 'mu_phases', 'gt_phases', 'ft_phases' and
'save_phases' (the JAX package has no Save phases).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderConfig
from ..constants import ENCODER_STEPS, equal_quality_tile_count
from ..parallel.mesh import check_device
from ..utils import dispatch
from ..utils.progress import StepProgress

from .state import EncoderState, resolve_device


class Encoder:
    def __init__(self, config: EncoderConfig | None = None, device='cuda',
                 mesh=None):
        """mesh: optional parallel.mesh.Mesh (make_mesh) of devices of
        `device`'s type (else ValueError). The state then lives on the
        mesh's first device, and the frame-axis-parallel stages cut their
        rows across the mesh with a byte-identical output stream
        (parallel.mesh_pipeline); without one, they run on the 1-shard
        mesh of `device`."""
        self.config = config or EncoderConfig()
        self.device = resolve_device(device)
        if mesh is not None:
            check_device(mesh, self.device)
            self.device = mesh.flat[0]
        self.state = EncoderState(config=self.config, device=self.device,
                                  mesh=mesh)
        first = ENCODER_STEPS.index(self.config.start_step)
        last = ENCODER_STEPS.index(self.config.end_step)
        self.progress = StepProgress(ENCODER_STEPS[first:last + 1])

    # -- individual steps ---------------------------------------------------

    def load(self, frames: np.ndarray, fps: float | None = None):
        from .load import run_load
        return self._timed('load', run_load, self.state, frames, fps)

    def dither(self):
        from .dither_step import run_dither
        return self._timed('dither', run_dither, self.state)

    def make_unique(self):
        from .unique import run_make_unique
        return self._timed('make_unique', run_make_unique, self.state)

    def global_tiling(self):
        from .global_tiling import run_global_tiling
        return self._timed('global_tiling', run_global_tiling, self.state)

    def frame_tiling(self):
        from .frame_tiling import run_frame_tiling
        return self._timed('frame_tiling', run_frame_tiling, self.state)

    def reindex(self):
        from .reindex import run_reindex
        return self._timed('reindex', run_reindex, self.state)

    def smooth(self):
        from .smooth import run_smooth
        return self._timed('smooth', run_smooth, self.state)

    def save(self, fast_lzma: bool = False) -> bytes:
        from .save import run_save
        return self._timed('save', run_save, self.state, fast_lzma)

    # -- drivers ------------------------------------------------------------

    def max_tiles(self) -> int:
        cfg = self.config
        raw = self.state.n_frames * self.state.tilemap_size
        if cfg.max_tiles > 0:
            return min(cfg.max_tiles, raw)
        return min(round(cfg.qb_tiles * equal_quality_tile_count(raw)), raw)

    def run_all(self, frames: np.ndarray, fps: float | None = None,
                fast_lzma: bool = False, profile_dir: str | None = None,
                step_hook=None) -> bytes:
        """Full pipeline Load..Save honouring start/end step config.

        profile_dir: when set, the run is traced by torch.profiler (host
        activity, and on a CUDA device the card's kernels and copies),
        each step under a 'step:<name>' annotation and each of its phases
        under '<step>/<key>' (utils.dispatch.span), and the trace is
        written into that directory as a Chrome trace
        (<host>_<pid>.<ms>.pt.trace.json; Perfetto, chrome://tracing and
        TensorBoard read it).
        step_hook: optional callable(step_name) invoked after each
        completed step."""
        if not profile_dir:
            return self._run_all_inner(frames, fps, fast_lzma, step_hook)
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(profile_dir)):
            return self._run_all_inner(frames, fps, fast_lzma, step_hook)

    def _run_all_inner(self, frames, fps, fast_lzma, step_hook) -> bytes:
        first = ENCODER_STEPS.index(self.config.start_step)
        last = ENCODER_STEPS.index(self.config.end_step)
        blob = b''
        for step in ENCODER_STEPS[first:last + 1]:
            if step == 'load':
                self.load(frames, fps)
            elif step == 'save':
                blob = self.save(fast_lzma=fast_lzma)
            else:
                getattr(self, step)()
            if step_hook is not None:
                step_hook(step)
        self._sharded_wall_metric()
        return blob

    def _sharded_wall_metric(self) -> None:
        """Fraction of the device wall clock spent in mesh-shardable
        stages (the Amdahl number for multi-device scaling): sharded =
        dither prepare+scan, FrameTiling mark/feats/assign, smooth,
        MakeUnique (the step and GlobalTiling's rerun) and the GT
        signature build (+ the KModes solve under mesh_kmodes, reported
        separately as frac_with_kmodes); the device wall excludes the
        host-only phases (load, save, the DL3/VAR quantize pool, the
        KModes merge). Computed on every run: on one device it is the
        coverage the mesh path would shard, on a mesh the measured one."""
        st, m = self.state.step_times, self.state.metrics
        dp = m.get('dither_phases') or {}
        gp = m.get('gt_phases') or {}
        fp = m.get('ft_phases') or {}
        sharded = (dp.get('prepare_kmeans', 0.0) + dp.get('dither', 0.0)
                   + fp.get('mark', 0.0) + fp.get('cand_feats', 0.0)
                   + fp.get('assign', 0.0) + st.get('smooth', 0.0)
                   + st.get('make_unique', 0.0)
                   + gp.get('gt_unique', 0.0)
                   + gp.get('sigs_bins', 0.0))
        device_wall = (st.get('dither', 0.0) - dp.get('quantize', 0.0)
                       + st.get('make_unique', 0.0)
                       + st.get('global_tiling', 0.0)
                       - gp.get('merge_host', 0.0)
                       + st.get('frame_tiling', 0.0)
                       + st.get('smooth', 0.0) + st.get('reindex', 0.0))
        m['mesh_sharded_wall'] = {
            'sharded_s': round(sharded, 3),
            'device_wall_s': round(device_wall, 3),
            'frac': round(sharded / max(device_wall, 1e-9), 3),
            'frac_with_kmodes': round(
                (sharded + gp.get('solve', 0.0))
                / max(device_wall, 1e-9), 3),
            'measured_on_mesh': self.state.mesh.size > 1,
            'mesh_kmodes': bool(self.config.mesh_kmodes)}

    # -- internals ----------------------------------------------------------

    def _timed(self, name, fn, *args):
        before = dispatch.snapshot()
        with dispatch.span(f'step:{name}') as step:
            result = fn(*args)
            dispatch.note('sync')
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
        self.state.step_times[name] = step.seconds
        self.state.metrics.setdefault('dispatches', {})[name] = \
            dispatch.delta(before)
        self._report(name)
        return result

    def _report(self, name):
        t = self.state.step_times[name]
        total = sum(self.state.step_times.values())
        self.progress.finish_step(name)
        print(f'Step: {name:<14} Time: {t:8.3f}  All: {total:8.3f}  '
              f'{self.progress.format_suffix()}')
