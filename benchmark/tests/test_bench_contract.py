"""BENCHMARK.json against the contract's form, every file it names found
by name, and the import rule (no JAX, no JAX package; the reference none
of the program)."""

import ast
import json
import os
import re
import subprocess
import sys
import types

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def short_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert set(SPEC) == KEYS["top"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
            assert KEYS[part] <= set(entry) <= KEYS[part] | extra, entry


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(part):
    names = [e["name"] for e in SPEC[part]]
    assert len(set(names)) == len(names)
    for e in SPEC[part]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert short_line(e[key]), e[key]
    metrics = [e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_paths_and_command():
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    for word in SPEC["command"]:
        assert short_line(word) and not word.startswith("/") and ".." not in word
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in SPEC["paths"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for root, _dirs, files in os.walk(os.path.join(harness.ROOT, "benchmark")):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.ROOT)
            if "__pycache__" not in rel:
                assert PATH.match(rel), rel


def test_metrics_rules():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for w in cells:
        got = [m["name"] for m in SPEC["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in got and len(got) >= 2
        assert any(w in m["workloads"] for m in SPEC["per_layer"])
    fours = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"]) and len(fours) <= 1


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "entries", c.traffic["entry"] + ".py"))
    mod = harness.entry_module(c)
    assert hasattr(mod, "Runner")
    assert c.traffic["input_pool"] > c.traffic["warm_calls"] >= 1
    for m in SPEC["per_layer"]:
        if c.applies(m):
            assert callable(harness.metric_reader(m["name"]).read)


def test_configs_state_their_cuts():
    for c in SPEC["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert all(k in conf for k in conf["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_bits", "_limbs")) for k in c["reduced"])
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def bench_sources():
    for root, _dirs, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_and_no_jax_package_imported():
    for path in bench_sources():
        bad = imported_tops(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = imported_tops(os.path.join(ref, f))
            assert not tops & {"plonky_tpu_torch", "plonky_tpu", "jax"}, (f, tops)


def test_top_level_names_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("plonky_tpu_torch_x", "plonky_tpu_torch.fields", "jaxfoo", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "plonky_tpu.fields", types.ModuleType("plonky_tpu.fields"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax", "plonky_tpu"]


def test_a_run_loads_no_jax():
    """Every cell's entry, readers and the program they import, in a
    process of their own: no module of JAX or the JAX package loaded."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "for w in harness.benchmark_spec()['workloads']:\n"
            "    c = harness.find_cell(w['name']); harness.entry_module(c)\n"
            "    [harness.metric_reader(m['name']) for m in c.per_layer if c.applies(m)]\n"
            "import plonky_tpu_torch.protocol.circuit, plonky_tpu_torch.poly.fft\n"
            "print(harness.forbidden_modules())\n") % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
