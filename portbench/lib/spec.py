"""Finds every file of a cell by the names in ``BENCHMARK.json``.

A configuration ``c`` is ``configs/c.json`` (its sizes) with
``configs/c.py`` (how the program under test is built and called for it)
and ``reference/c.py`` (its plain reference); a traffic mix ``t`` is
``mixes/t.json`` (its numbers), which names its entry ``e``,
``entries/e.py`` (what is called per request, and how); a cell ``w`` has
its correctness limits in ``limits/w.json``; a metric ``m`` is read by
``metrics/m.py``. A later cell, mix, entry or metric is added by adding
files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(BENCHMARK)


def path(kind, name, ext):
    return os.path.join(HERE, kind, name + ext)


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name):
    return load_json(path("configs", name, ".json"))


def mix(name):
    return load_json(path("mixes", name, ".json"))


def limits(name):
    return load_json(path("limits", name, ".json"))


def module(kind, name):
    """The module ``<kind>/<name>.py``, loaded from its file (names may
    hold '-' and '.')."""
    mod_name = f"portbench.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(
        mod_name, path(kind, name, ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics(bench, cell, trace):
    """The (entry, reader module) of every metric the cell reports: its
    end-to-end metrics with ``trace`` 0, its per-layer metrics with 1."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if cell["name"] in m.get("workloads", [cell["name"]]):
            out.append((m, module("metrics", m["name"])))
    return out
