"""device_idle_pct: the share of the traced window in which no kernel,
copy or fill ran on the card (trace.summarize: the union of the device
intervals against the first step's start to the last step's end)."""


def read(window):
    t = window.trace
    if not t or t['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
