"""The benchmark's description and the files it names, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics. Everything that belongs to one of them sits in a
file of its own under the benchmark's directory, which the harness finds by
the name alone, so a new cell, configuration, traffic mix or metric is
added as files and an entry, and no file that is there changes:

* ``configs/<config>.json``: a configuration (the entry's ``file``);
* ``traffic/<traffic>.json``: a traffic mix, read by ``generate.py``; it
  names its loop and its plant kinds, each a module of its own:
* ``loops/<loop>.py``: how a run drives the program (``drive(ctx)``);
* ``plants/<kind>.py``: a kind of planted amplicon (``add(plan, params)``);
* ``metrics/<metric>.py``: a metric's reader, ``read(run)`` -> a number, or
  None when the run holds nothing for it to read.

A metric entry without a ``workloads`` key applies to every cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    metrics, read from the checkout at ``root``."""

    def __init__(self, root: str, name: str):
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            bench = json.load(fh)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.root = root
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        with open(os.path.join(root, conf["file"])) as fh:
            self.config = json.load(fh)
        # the directory the configuration lies in is the benchmark's own
        self.dir = os.path.dirname(os.path.dirname(os.path.join(root, conf["file"])))
        with open(os.path.join(self.dir, "traffic", f"{self.entry['traffic']}.json")) as fh:
            self.traffic = json.load(fh)
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return load(self.dir, "metrics", metric).read

    def loop(self):
        """The module of the traffic's ``loop``."""
        return load(self.dir, "loops", self.traffic["loop"])


_LOADED: dict = {}


def load(bench_dir: str, kind: str, name: str):
    """The module ``<bench_dir>/<kind>/<name>.py``, loaded once."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if path not in _LOADED:
        if not os.path.exists(path):
            raise SystemExit(f"no {kind} module {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"pcr_bench_{kind}_" + re.sub(r"\W", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
