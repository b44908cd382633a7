"""One reader per per-layer metric, found by the metric's name
(cells.reader): read(window) returns the metric's value, or None where
the run holds nothing to read. `window` is run.Window."""
