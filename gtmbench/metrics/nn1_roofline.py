"""nn1_roofline: FrameTiling's stage-3 search (K1 with its prepare
and merge kernels, csrc/nn1.cu) against its roofline on the card.

The work is the search's, as the shapes of its calls fix it: per call,
2 Q C D operations and the bytes of each input read once (Q D + C D
f32) and each output written once (Q indices and Q distances, 4 bytes
each). Its least time is the larger of operations over the float32 peak
outside the tensor cores and bytes over the memory's peak, summed over
the window's calls; the share is that over the device time the trace
gives the kernels whose names hold 'nn1' (not the bf16 ones).
"""
from gtmbench.peaks import H100


def read(window):
    t = window.trace
    if not t or not window.calls:
        return None
    busy = sum(s for name, s in t['op_s'].items()
               if 'nn1' in name and 'bf16' not in name)
    if busy <= 0:
        return None
    least = 0.0
    for q, c, d in window.calls:
        ops = 2.0 * q * c * d
        nbytes = 4.0 * (q * d + c * d) + 8.0 * q
        least += max(ops / H100['f32_flops'], nbytes / H100['hbm_bytes_s'])
    return 100.0 * least / busy
