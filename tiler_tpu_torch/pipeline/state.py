"""Encoder state: the counterpart of tiler_tpu/pipeline/state.py.

Host fields are numpy arrays with the JAX package's names, shapes and
dtypes (see that module's docstring). The device mirrors are torch
tensors on `state.device`: the source tiles (built once from the frames)
and the dithered tile pixels `tiles_pal`, which live on the device from
Dither to Reindex and come to the host on first `.tiles_pal` access.

`from_reference_state` / `state_arrays` carry a state across the two
packages as plain numpy arrays and scalars, named by ARRAY_FIELDS (the
fields of the JAX package's checkpoint format): the parity tests load
the JAX package's state into the port and build one from the port's
this way. This module imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import EncoderConfig, FTQuality
from ..constants import TILE_W
from ..parallel.mesh import Mesh, make_mesh
from ..utils.dispatch import note

# the state's array fields, in the JAX package's checkpoint order
ARRAY_FIELDS = [
    'frames_rgb', 'fs_pixels', 'tm_tile', 'tm_pal', 'tm_h', 'tm_v',
    'stm_tile', 'stm_pal', 'stm_h', 'stm_v', 'stm_smooth',
    'tiles_rgb', 'tiles_pal', 'tile_active', 'tile_use', 'tile_dpi',
    'keyframes', 'palettes_rgb', 'palette_centroids',
]
_SCALAR_FIELDS = ['fps', 'tilemap_w', 'tilemap_h']


def resolve_device(device) -> torch.device:
    """torch.device from a name; a CUDA device must exist (the port never
    falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but torch finds no CUDA '
                           'device')
    return dev


@dataclasses.dataclass
class EncoderState:
    config: EncoderConfig
    # the card unless the caller names another device (RuntimeError
    # without one), as Encoder
    device: torch.device = 'cuda'
    fps: float = 24.0
    tilemap_w: int = 0
    tilemap_h: int = 0

    frames_rgb: Optional[np.ndarray] = None
    fs_pixels: Optional[np.ndarray] = None

    tm_tile: Optional[np.ndarray] = None
    tm_pal: Optional[np.ndarray] = None
    tm_h: Optional[np.ndarray] = None
    tm_v: Optional[np.ndarray] = None
    stm_tile: Optional[np.ndarray] = None
    stm_pal: Optional[np.ndarray] = None
    stm_h: Optional[np.ndarray] = None
    stm_v: Optional[np.ndarray] = None
    stm_smooth: Optional[np.ndarray] = None

    tiles_rgb: Optional[np.ndarray] = None
    _tiles_pal_host: Optional[np.ndarray] = None
    _tiles_pal_dev: Optional[torch.Tensor] = None
    tile_active: Optional[np.ndarray] = None
    tile_use: Optional[np.ndarray] = None
    tile_dpi: Optional[np.ndarray] = None

    keyframes: Optional[np.ndarray] = None
    palettes_rgb: Optional[np.ndarray] = None
    palette_centroids: Optional[np.ndarray] = None
    changed_mask: Optional[np.ndarray] = None

    # the parallel.mesh.Mesh the frame-axis-parallel stages cut their rows
    # across (parallel.mesh_pipeline.map_rows): Encoder(mesh=...) or the
    # CLI's --devices N, else the 1-shard mesh of `device`. Not
    # serialized by checkpoints: callers re-attach it after a load.
    mesh: Mesh = dataclasses.field(default=None, repr=False)

    step_times: dict = dataclasses.field(default_factory=dict)
    metrics: dict = dataclasses.field(default_factory=dict)
    _src_tiles: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mesh is None:
            self.mesh = make_mesh(devices=[self.device])

    def device_source_tiles(self) -> torch.Tensor:
        """[F*TH*TW, 8, 8, 3] uint8 source tiles on the device, in
        frame-major cell order (independent of the tilemap); built once
        per frames array from one upload of the frames."""
        key = id(self.frames_rgb)
        if self._src_tiles.get('key') != key:
            note('h2d')
            fr = torch.from_numpy(self.frames_rgb).to(self.device)
            f, hh, ww, _ = fr.shape
            th, tw = hh // TILE_W, ww // TILE_W
            x = fr.reshape(f, th, TILE_W, tw, TILE_W, 3)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(
                f * th * tw, TILE_W, TILE_W, 3).contiguous()
            self._src_tiles = {'key': key, 'arr': x}
        return self._src_tiles['arr']

    # -- tiles_pal host/device residency: exactly one side is
    # authoritative, as in the JAX package ------------------------------

    @property
    def tiles_pal(self) -> Optional[np.ndarray]:
        if self._tiles_pal_host is None and self._tiles_pal_dev is not None:
            note('d2h')
            self._tiles_pal_host = self._tiles_pal_dev.cpu().numpy().copy()
        return self._tiles_pal_host

    @tiles_pal.setter
    def tiles_pal(self, value) -> None:
        self._tiles_pal_host = value
        self._tiles_pal_dev = None

    def set_tiles_pal_device(self, arr: torch.Tensor) -> None:
        """Make the device tensor authoritative (host copy is stale)."""
        self._tiles_pal_dev = arr
        self._tiles_pal_host = None

    def peek_tiles_pal(self) -> Optional[np.ndarray]:
        """Read-only snapshot of tiles_pal for serialization: it neither
        drops the device tensor nor leaves a host copy behind, so the
        steps after a checkpoint go on with the same device tensor."""
        if self._tiles_pal_host is None and self._tiles_pal_dev is not None:
            note('d2h')
            return self._tiles_pal_dev.cpu().numpy()
        return self._tiles_pal_host

    def release_device(self) -> None:
        """Drop every device tensor the state holds (the source tiles and
        the device side of tiles_pal, brought to the host first when it
        is the authoritative one). The host fields stay valid: a finished
        GOP's state can be kept for assembly without holding the card's
        memory."""
        if self._tiles_pal_host is None and self._tiles_pal_dev is not None:
            note('d2h')
            self._tiles_pal_host = self._tiles_pal_dev.cpu().numpy().copy()
        self._tiles_pal_dev = None
        self._src_tiles = {}

    def device_tiles_pal(self) -> torch.Tensor:
        """tiles_pal on the device, uploaded once when the host side is
        authoritative."""
        if self._tiles_pal_dev is None:
            note('h2d')
            self._tiles_pal_dev = torch.from_numpy(
                np.ascontiguousarray(self._tiles_pal_host)).to(self.device)
        return self._tiles_pal_dev

    @property
    def n_frames(self) -> int:
        return 0 if self.frames_rgb is None else len(self.frames_rgb)

    @property
    def tilemap_size(self) -> int:
        return self.tilemap_w * self.tilemap_h

    @property
    def screen_w(self) -> int:
        return self.tilemap_w * TILE_W

    @property
    def screen_h(self) -> int:
        return self.tilemap_h * TILE_W

    @property
    def n_tiles(self) -> int:
        if self._tiles_pal_host is not None:
            return len(self._tiles_pal_host)
        if self._tiles_pal_dev is not None:
            return int(self._tiles_pal_dev.shape[0])
        return 0

    def kf_of_frame(self) -> np.ndarray:
        """[F] keyframe index per frame."""
        kf = np.zeros(self.n_frames, np.int32)
        for k, (s, e) in enumerate(self.keyframes):
            kf[s:e + 1] = k
        return kf


def _own_config(cfg) -> EncoderConfig:
    """The port's EncoderConfig with the fields of any config object that
    carries them (the JAX package's dataclass has the same names)."""
    if isinstance(cfg, EncoderConfig):
        return cfg
    kv = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(EncoderConfig)}
    kv['ft_quality'] = FTQuality(int(kv['ft_quality']))
    return EncoderConfig(**kv)


def from_reference_state(ref, device) -> EncoderState:
    """A port state holding copies of the arrays of `ref`: a mapping (as
    state_arrays returns) or any object with those attributes, such as
    the JAX package's EncoderState. A device-resident tiles_pal is read
    through the object's peek_tiles_pal() where it has one."""
    if isinstance(ref, dict):
        get = ref.get
    else:
        def get(name, default=None):
            if name == 'tiles_pal' and hasattr(ref, 'peek_tiles_pal'):
                return ref.peek_tiles_pal()
            return getattr(ref, name, default)
    st = EncoderState(config=_own_config(get('config')),
                      device=torch.device(device))
    for f in _SCALAR_FIELDS:
        setattr(st, f, get(f))
    for f in ARRAY_FIELDS + ['changed_mask']:
        v = get(f)
        setattr(st, f, None if v is None else np.array(v))
    st.step_times = dict(get('step_times') or {})
    st.metrics = dict(get('metrics') or {})
    return st


def state_arrays(st: EncoderState) -> dict:
    """The state as a plain dict: config, the scalars, every field of
    ARRAY_FIELDS and changed_mask as host numpy arrays (the device tiles
    come to the host here), step_times and metrics."""
    out = {'config': st.config}
    for f in _SCALAR_FIELDS + ARRAY_FIELDS + ['changed_mask']:
        out[f] = getattr(st, f)
    out['step_times'] = st.step_times
    out['metrics'] = st.metrics
    return out
