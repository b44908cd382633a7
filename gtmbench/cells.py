"""What one cell of BENCHMARK.json is, read from the benchmark's data
files by name: the cell's configuration (the config's `file`), its
traffic (gtmbench/traffic/<traffic>.json), the limits of its correctness
checks (gtmbench/limits/<workload>.json) and the metrics it reports,
each per-layer metric with its reader (gtmbench/metrics/<name>.py, the
name's '.' and '-' written '_'). Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict          # the configuration file
    traffic_name: str
    traffic: dict         # gtmbench/traffic/<traffic>.json
    limits: dict          # gtmbench/limits/<workload>.json
    chips: int
    end_to_end: list      # BENCHMARK.json's entries that this cell reports
    per_layer: list
    root: str


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload` of root/BENCHMARK.json. KeyError for a
    cell that is not there."""
    bench = _json(os.path.join(root, 'BENCHMARK.json'))
    w = {c['name']: c for c in bench['workloads']}[workload]
    conf = {c['name']: c for c in bench['configs']}[w['config']]
    here = os.path.join(root, 'gtmbench')
    return Cell(
        name=workload, config_name=w['config'],
        config=_json(os.path.join(root, conf['file'])),
        traffic_name=w['traffic'],
        traffic=_json(os.path.join(here, 'traffic', w['traffic'] + '.json')),
        limits=_json(os.path.join(here, 'limits', workload + '.json')),
        chips=int(w['chips']),
        end_to_end=[m for m in bench['end_to_end']
                    if _applies(m, workload)],
        per_layer=[m for m in bench['per_layer'] if _applies(m, workload)],
        root=root)


def reader(metric: str, root: str = ROOT):
    """The read(window) function of a per-layer metric's reader file."""
    mod = metric.replace('.', '_').replace('-', '_')
    path = os.path.join(root, 'gtmbench', 'metrics', mod + '.py')
    spec = importlib.util.spec_from_file_location(
        f'gtmbench_metric_{mod}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def encoder_config(cls, fields: dict):
    """An EncoderConfig (`cls`) of a configuration file's fields; an enum
    field is given by its member's name. ValueError for a field that cls
    does not have."""
    known = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(fields) - set(known)
    if unknown:
        raise ValueError(f'unknown EncoderConfig fields: {sorted(unknown)}')
    kw = {}
    for name, v in fields.items():
        kind = type(known[name].default)
        if isinstance(v, str) and hasattr(kind, '__members__'):
            v = kind[v]
        kw[name] = v
    return cls(**kw)
