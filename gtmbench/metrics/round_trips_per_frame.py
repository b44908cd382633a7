"""round_trips_per_frame: the program's host-card round trips and kernel
launches (utils/dispatch.py: metrics['dispatches'][step]['total'] over
the steps) per frame, summed over the window's encodes."""


def read(window):
    total = 0
    for rec in window.encodes:
        d = rec['metrics'].get('dispatches')
        if not d:
            return None
        total += sum(v['total'] for v in d.values())
    return total / window.frames if window.frames else None
