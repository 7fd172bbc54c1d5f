"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) pairs a configuration
(``configs/<config>.json``, the file listed in ``configs``) with a
traffic mix (``traffic/<traffic>.json``), whose ``entry`` names the
module in ``entries/``. ``limits/<cell>.json`` holds the limit of each
number that decides ``correct``; ``metrics/<metric>.json`` says which
reader in ``readers/`` computes a metric.
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import Dict, List, Tuple

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE_RE = re.compile(r"[^\t\r\n]{1,200}")


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _named(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    return _json(root / _named(bench["configs"], name, "config")["file"])


def traffic(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "traffic" / f"{name}.json")


def limits(cell: str, bench_dir: pathlib.Path = BENCH_DIR) -> Dict[str, float]:
    return _json(bench_dir / "limits" / f"{cell}.json")


def metrics(bench: dict, cell: str, trace: bool,
            bench_dir: pathlib.Path = BENCH_DIR) -> List[Tuple[dict, dict]]:
    """(BENCHMARK.json entry, definition file) of each metric the cell
    reports: the ``per_layer`` ones with ``trace``, else the
    ``end_to_end`` ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m, _json(bench_dir / "metrics" / f"{m['name']}.json"))
            for m in group if cell in m.get("workloads", [cell])]


def problems(bench: dict, root: pathlib.Path = ROOT,
             bench_dir: pathlib.Path = BENCH_DIR) -> List[str]:
    """What in ``bench`` breaks the benchmark's naming and reference
    rules, or names a file that is not there."""
    out = []

    def name_ok(value, where):
        if not (isinstance(value, str) and NAME_RE.fullmatch(value)):
            out.append(f"{where}: bad name {value!r}")

    def line_ok(value, where):
        if not (isinstance(value, str) and LINE_RE.fullmatch(value)):
            out.append(f"{where}: bad text {value!r}")

    for key, items in (("configs", bench["configs"]),
                       ("workloads", bench["workloads"]),
                       ("end_to_end", bench["end_to_end"]),
                       ("per_layer", bench["per_layer"])):
        names = [item.get("name") for item in items]
        if len(set(names)) != len(names):
            out.append(f"{key}: repeated names")
        for item in items:
            name_ok(item.get("name"), key)
    for c in bench["configs"]:
        for k in c["reduced"]:
            name_ok(k, f"config {c['name']} reduced")
        line_ok(c["source"], f"config {c['name']} source")
        line_ok(c["why"], f"config {c['name']} why")
        if not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        name_ok(w["config"], f"workload {w['name']} config")
        name_ok(w["traffic"], f"workload {w['name']} traffic")
        line_ok(w["why"], f"workload {w['name']} why")
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: unknown config")
        for path in (bench_dir / "traffic" / f"{w['traffic']}.json",
                     bench_dir / "limits" / f"{w['name']}.json"):
            if not path.is_file():
                out.append(f"workload {w['name']}: no file {path.name}")
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not (isinstance(m.get("unit"), str)
                and UNIT_RE.fullmatch(m["unit"])):
            out.append(f"metric {m.get('name')}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m['name']}: bad better")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"metric {m['name']}: unknown cell {cell}")
        if not (bench_dir / "metrics" / f"{m['name']}.json").is_file():
            out.append(f"metric {m['name']}: no definition file")
    for m in bench["per_layer"]:
        line_ok(m["layer"], f"metric {m['name']} layer")
        if m["moves"] not in e2e:
            out.append(f"metric {m['name']}: moves unknown {m['moves']}")
    return out
