"""The benchmark as data: every cell finds its files by name, a cell added
as files alone is found, the result line keeps to the contract's keys,
the command refuses to run without a card, and no module of the
benchmark imports JAX, the JAX package, or (in the references) the
program."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import bench  # noqa: E402
from portbench.tests import tiny  # noqa: E402

ROOT = tiny.ROOT
PB = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "breakdown", "checks"}


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_resolves_its_files(cell):
    ctx = bench.load_cell(ROOT, cell)
    assert ctx["mix"]["kind"] in bench.DRIVERS
    assert (PB / "reference" / f"{ctx['cfg']['reference']}.py").is_file()
    assert ctx["limits"]["limits"]
    assert any(m["name"] == "setup_s" for m in ctx["end_to_end"])
    assert len(ctx["end_to_end"]) >= 2 and ctx["per_layer"]
    for m in ctx["per_layer"]:
        assert callable(bench.reader(ROOT, m["name"]))


def test_every_config_file_is_used_and_under_paths():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])


def test_cell_added_as_files_is_found(tmp_path):
    root = tiny.make_root(tmp_path)
    for cell in tiny.CELLS:
        ctx = bench.load_cell(root, cell)
        assert ctx["cfg"]["name"] == tiny.CELLS[cell][0]
        assert ctx["per_layer"]


def test_result_line_keeps_to_the_contract(tmp_path):
    root = tiny.make_root(tmp_path)
    for trace in (0, 1):
        ctx = bench.load_cell(root, "tiny-dense.bursts")
        out = bench.execute(ctx, 2 ** 31 + 7, 0.5, trace, torch.device("cpu"))
        res = out["result"]
        assert set(res) <= RESULT_KEYS
        assert list(res)[-1] == "checks"
        assert res["correct"] is True
        for m in res["metrics"].values():
            assert set(m) == {"value", "unit"}
        assert {"platform", "kind", "count",
                "memory_peak_bytes"} <= set(res["device"])
        json.dumps(res)


def _command(cwd: Path, **env) -> subprocess.CompletedProcess:
    b = _bench()
    return subprocess.run(
        b["command"] + ["--workload", b["workloads"][0]["name"], "--seed",
                        "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **env))


def test_command_fails_without_a_card():
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_command_fails_with_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, PYTHONPATH="")
    assert out.returncode != 0 and out.stdout.strip() == ""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


def _sources(sub: str = "") -> list:
    return [p for p in sorted((PB / sub).rglob("*.py"))
            if "tests" not in p.relative_to(PB).parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        found = _imports(path) & set(bench.FORBIDDEN)
        assert not found, (path, found)


def test_references_import_nothing_of_the_program():
    for path in _sources("reference"):
        assert "repro_torch" not in _imports(path), path


def test_forbidden_names_compare_whole():
    names = ["repro_torch.models.model", "reprolike", "jaxlib.xla_client",
             "repro.core.cgroup", "flaxen", "jax"]
    assert bench.forbidden_modules(names) == ["jax", "jaxlib", "repro"]
    assert bench.forbidden_modules(["repro_torch", "portbench"]) == []
