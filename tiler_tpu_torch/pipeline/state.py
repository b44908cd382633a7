"""Encoder state: the counterpart of tiler_tpu/pipeline/state.py.

Host fields are numpy arrays with the JAX package's names, shapes and
dtypes (see that module's docstring). The device mirrors are torch
tensors on `state.device`: the source tiles (built once from the frames)
and the dithered tile pixels `tiles_pal`, which live on the device from
Dither to Reindex and come to the host on first `.tiles_pal` access.

`from_reference_state` / `to_reference_state` carry a state across the
two packages through the numpy arrays that the checkpoint format names
(tiler_tpu.utils.checkpoint._ARRAY_FIELDS): the parity tests load the
JAX package's state into the port this way, and Save hands the port's
state to the shared GTM writer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tiler_tpu.config import EncoderConfig
from tiler_tpu.constants import TILE_W
from tiler_tpu.utils.checkpoint import _ARRAY_FIELDS


@dataclasses.dataclass
class EncoderState:
    config: EncoderConfig
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device('cpu'))
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

    step_times: dict = dataclasses.field(default_factory=dict)
    metrics: dict = dataclasses.field(default_factory=dict)
    _src_tiles: dict = dataclasses.field(default_factory=dict, repr=False)

    def device_source_tiles(self) -> torch.Tensor:
        """[F*TH*TW, 8, 8, 3] uint8 source tiles on the device, in
        frame-major cell order (independent of the tilemap); built once
        per frames array from one upload of the frames."""
        key = id(self.frames_rgb)
        if self._src_tiles.get('key') != key:
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

    def device_tiles_pal(self) -> torch.Tensor:
        """tiles_pal on the device, uploaded once when the host side is
        authoritative."""
        if self._tiles_pal_dev is None:
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


def from_reference_state(ref, device) -> EncoderState:
    """A port state holding copies of a tiler_tpu EncoderState's arrays."""
    st = EncoderState(config=ref.config, device=torch.device(device),
                      fps=ref.fps, tilemap_w=ref.tilemap_w,
                      tilemap_h=ref.tilemap_h)
    for f in _ARRAY_FIELDS:
        v = ref.peek_tiles_pal() if f == 'tiles_pal' else getattr(ref, f)
        setattr(st, f, None if v is None else np.array(v))
    if ref.changed_mask is not None:
        st.changed_mask = np.array(ref.changed_mask)
    st.step_times = dict(ref.step_times)
    st.metrics = dict(ref.metrics)
    return st


def to_reference_state(st: EncoderState):
    """A tiler_tpu EncoderState holding the port state's host arrays (the
    device tiles come to the host here)."""
    from tiler_tpu.pipeline.state import EncoderState as RefState
    ref = RefState(config=st.config, fps=st.fps, tilemap_w=st.tilemap_w,
                   tilemap_h=st.tilemap_h)
    for f in _ARRAY_FIELDS:
        setattr(ref, f, getattr(st, f))
    ref.changed_mask = st.changed_mask
    ref.step_times = st.step_times
    ref.metrics = st.metrics
    return ref
