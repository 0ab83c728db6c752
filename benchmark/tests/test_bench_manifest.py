"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import copy
import json
import re

import pytest

from benchmark import manifest

M = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_allowed():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[kind]]
        assert len(names) == len(set(names)), kind
        assert all(NAME.match(n) for n in names), kind
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://") and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert data["tf32"] is False and data["dtype"] in ("float32", "float64")
        assert data["krylov_relres_max"] > 0 and "krylov_relres_max" in data["guarantees"]


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        spec = manifest.cell_spec(w["name"], M)
        assert spec.config["name"] == w["config"]
        assert set(spec.limits) >= {"velocity_l2", "failed_steps"}
        lo, hi = spec.traffic["kappa"]
        assert 0 < lo <= hi


def test_metrics_entries():
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in {w["name"] for w in M["workloads"]} for c in m.get("workloads", []))


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in manifest.cell_metrics(M, cell, "end_to_end")}
    per_layer = manifest.cell_metrics(M, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_a_name_without_its_file_is_refused():
    m = copy.deepcopy(M)
    m["workloads"][0]["traffic"] = "no-such-traffic"
    with pytest.raises(FileNotFoundError):
        manifest.cell_spec(m["workloads"][0]["name"], m)
    m = copy.deepcopy(M)
    m["per_layer"].append(dict(m["per_layer"][0], name="no_such_metric"))
    with pytest.raises(FileNotFoundError):
        manifest.cell_spec(m["workloads"][0]["name"], m)
    with pytest.raises(KeyError):
        manifest.cell_spec("no-such-cell", M)


@pytest.mark.parametrize("where,key,value", [
    ("config", "discretisation", "dg"),
    ("config", "dtype", "bfloat16"),
    ("config", "forcing", "constant"),
    ("config", "krylov_relres_max", 0.0),
    ("traffic", "mesh", "disk"),
    ("traffic", "problem", "shear_layer"),
])
def test_a_value_the_harness_does_not_run_is_refused(where, key, value, monkeypatch):
    """A configuration or traffic value that no code of the harness runs is
    refused when the cell loads, not run as something else."""
    read = manifest._read_json

    def altered(path, what):
        data = read(path, what)
        return dict(data, **{key: value}) if what.startswith(where) else data

    monkeypatch.setattr(manifest, "_read_json", altered)
    with pytest.raises((ValueError, FileNotFoundError)):
        manifest.cell_spec(M["workloads"][0]["name"], M)
