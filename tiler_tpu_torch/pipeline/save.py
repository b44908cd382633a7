"""Save step: the GTM stream through the shared writer
(tiler_tpu/pipeline/save.py, which imports no JAX), from the port's state
carried across as a tiler_tpu EncoderState."""
from __future__ import annotations

from tiler_tpu.pipeline.save import run_save as _run_save_shared

from .state import EncoderState, to_reference_state


def run_save(state: EncoderState, fast_lzma: bool = False) -> bytes:
    ref = to_reference_state(state)
    blob = _run_save_shared(ref, fast_lzma=fast_lzma)
    state.metrics.update(gtm_bytes=ref.metrics['gtm_bytes'],
                         kbps=ref.metrics['kbps'])
    return blob
