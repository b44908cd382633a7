"""Typed encoder configuration.

Replaces the reference's GUI state (main.lfm control defaults, read at step
start, e.g. main.pas:1021-1022, 886-890, 962-964, 1356) with a single
dataclass. Defaults follow the shipped .lfm values: 16-color palettes x 128,
Knoll dithering, wavelet features, DL3 quantizer, FT quality Medium,
temporal smoothing 20/1000, VAR 95%, Yliluoma mix 4, DL BPC 7.
"""
from __future__ import annotations

import dataclasses
import enum


class FTQuality(enum.IntEnum):
    """Frame-tiling candidate expansion quality (main.pas:141)."""
    FAST = 0
    MEDIUM = 1
    SLOW = 2


_STEP_NAMES = ('load', 'dither', 'make_unique', 'global_tiling',
               'frame_tiling', 'reindex', 'smooth', 'save')


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    # palette shape (cbxPalSize / cbxPalCount)
    tile_palette_size: int = 16
    palette_count: int = 128

    # tile budget: max_tiles<=0 means auto from qb_tiles (main.pas:1023,1432-1439)
    qb_tiles: float = 2.0
    max_tiles: int = 0

    # dithering (chkUseTK, cbxYilMix, chkDitheringGamma)
    use_thomas_knoll: bool = True
    yliluoma_mix: int = 4
    dithering_gamma: bool = False

    # palette quantization (chkUseDL3, cbxDLBPC, sePalVAR)
    use_dl3: bool = True
    dl3_bpc: int = 7
    # exact DL3 below this many distinct bins; above, the rare-color tail
    # pre-merges into the head first. Measured sweep (docs/RESULTS.md):
    # byte-identical streams at 1024/4096/exact on the reference's own
    # city+football content; on adversarial uniform noise exact buys
    # +0.047 dB for 19x the quantize time. 0 disables capping (always
    # exact, reference semantics over up to 2^21 bins).
    dl3_bin_cap: int = 1024
    pal_var: float = 0.95

    # psychovisual features (chkUseWL)
    use_wavelets: bool = True

    # frame tiling (cbxFTQ, chkFTGamma)
    ft_quality: FTQuality = FTQuality.MEDIUM
    ft_gamma: bool = False
    ft_palette_tol: float = 0.05

    # temporal smoothing (seTempoSmoo/1000)
    smoothing_strength: float = 0.020

    # gammas (seEncGamma, seVisGamma; main.lfm:400,412)
    encoder_gamma: float = 1.8
    visual_gamma: float = 0.5

    # ingestion
    start_frame: int = 0
    frame_count: int = 0  # 0 = autodetect
    scaling: float = 1.0
    fps: float = 24.0

    # KModes multi-restart: 0 = single solve from the computed min-byte-sum
    # starting row (the reference's effective main-path behavior,
    # main.pas:4300-4308); N > 0 = best-of-N golden-ratio-spread restarts
    # per bin (kmodes.pas:949-966, lowest cost wins — the reference wires
    # cRandomKModesCount = 7, main.pas:21, for bins without a computed
    # start). Restarts run as extra batch lanes: ~N x GlobalTiling solve
    # cost.
    kmodes_restarts: int = 0

    # distributed per-bin KModes under a device mesh (GlobalTiling).
    # Kept so that configurations carry over; the single-device port
    # attaches no mesh and ignores it.
    mesh_kmodes: bool = False

    # keyframe-stream compression: 'auto' (default) = per-keyframe min
    # of the native optimal-parse lc=8 encoder and liblzma's optimal
    # lc=3 — measured 25.7%/28.5% smaller than the reference's own
    # published demo streams (docs/RESULTS.md round 4; degrades to lc3
    # with a warning on hosts without a C++ toolchain); 'lc8' = native
    # only, matching the reference's `lzma.exe e -lc8 -eos`
    # (extern.pas:224); 'lc3' = liblzma only; 'best' = sweeps native
    # (lc,lp,pb) configs too (~1% smaller again, ~3x compression cost —
    # for final distribution encodes/transcode). fast_lzma (the bench/
    # preview path) uses the fast presets of whichever modes run.
    lzma_mode: str = 'auto'

    # GTS tileset reload instead of global tiling (chkReload)
    reload_tileset: str | None = None

    # pipeline range (cbxStartStep/cbxEndStep): names from constants.ENCODER_STEPS
    start_step: str = 'load'
    end_step: str = 'save'

    def __post_init__(self):
        if not (1 <= self.palette_count <= 256):
            raise ValueError('palette_count must be 1..256 '
                             '(8-bit palette attr field)')
        if not (2 <= self.tile_palette_size <= 256):
            raise ValueError('tile_palette_size must be 2..256')
        if self.start_step not in _STEP_NAMES or \
                self.end_step not in _STEP_NAMES:
            raise ValueError(f'steps must be one of {_STEP_NAMES}')
        if self.lzma_mode not in ('lc3', 'lc8', 'auto', 'best'):
            raise ValueError(
                "lzma_mode must be 'lc3', 'lc8', 'auto' or 'best'")

    def dithering_gamma_lut(self) -> int:
        """-1 = linear, 0 = encoder gamma LUT index (main.pas:886)."""
        return 0 if self.dithering_gamma else -1

    def ft_gamma_lut(self) -> int:
        return 0 if self.ft_gamma else -1
