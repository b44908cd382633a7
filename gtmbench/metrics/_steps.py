"""What the step-time readers share: milliseconds per frame of one entry
of the program's step clocks or phase clocks, summed over the window's
encodes. A step clock is the host's wall of the step, which ends in a
device synchronize (Encoder._timed)."""


def ms_per_frame(window, steps=(), phases=None, phase=None):
    """steps: names in each encode's step_times; phases/phase: a phase in
    metrics[phases] (dither_phases, ft_phases, ...). None where an encode
    lacks one."""
    total = 0.0
    for rec in window.encodes:
        for s in steps:
            if s not in rec['step_times']:
                return None
            total += rec['step_times'][s]
        if phases is not None:
            got = (rec['metrics'].get(phases) or {}).get(phase)
            if got is None:
                return None
            total += got
    return 1e3 * total / window.frames if window.frames else None
