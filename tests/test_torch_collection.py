"""The test suite collects without torch: each port test file skips itself
(``pytest.importorskip("torch")`` before any import of the port), so a
torch-less run, the repository's CI test job among them, still collects
and runs every reference test.  Pinned by collecting ``tests/`` in a
subprocess whose ``sitecustomize`` blocks ``import torch``."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCK_TORCH = 'import sys\nsys.modules["torch"] = None\n'


def test_collects_with_torch_blocked(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(BLOCK_TORCH)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=540)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    ids = [line for line in out.stdout.splitlines() if "::" in line]
    files = {line.split("::")[0] for line in ids}
    # the reference's tests are collected
    assert {"tests/test_kernels.py", "tests/test_engine.py",
            "tests/test_cgroup.py"} <= files
    # the port's files that import torch are skipped, not collected
    port = {f for f in files if Path(f).name.startswith("test_torch_")}
    assert port <= {"tests/test_torch_replay.py",
                    "tests/test_torch_collection.py"}, port
