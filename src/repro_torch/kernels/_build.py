"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds.  Libraries go to ``build/kernels/`` at the root
of the checkout, named by a hash of the source, the ``csrc/`` headers it
includes and the flags, so a stale library is never loaded.  Nothing here
runs at import time: a kernel module asks for its library inside the
function that launches it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas=-v: registers, shared memory and spills of every kernel go to
# the build log beside each library
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]
# per-source extra flags: the enforcement kernels must not contract
# multiply-adds behind the decision code's back (see the source note)
EXTRA_FLAGS = {"enforcement": ["--fmad=false"], "decode_attention": [],
               "flash_attention": [], "mamba_scan": [], "mla_decode": []}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_loaded: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME or PATH); the CUDA kernels are "
            "built on the machine that has the card")
    return found


def _sources(path: Path, seen: dict) -> dict:
    """``path`` and every ``csrc/`` header it includes, transitively, as
    {path: bytes}."""
    text = path.read_bytes()
    seen[path] = text
    for name in _INCLUDE.findall(text):
        dep = (path.parent / name.decode()).resolve()
        if dep.is_file() and dep not in seen:
            _sources(dep, seen)
    return seen


def _command(name: str) -> tuple[list, Path]:
    src = CSRC / f"{name}.cu"
    flags = BASE_FLAGS + ARCH + EXTRA_FLAGS[name]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path, text in sorted(_sources(src.resolve(), {}).items()):
        digest.update(path.name.encode() + b"\0" + text)
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    return [nvcc(), *flags, "-o", str(out), str(src)], out


def build_all(names=tuple(EXTRA_FLAGS)) -> dict:
    """Compile every named source that has no library yet, one ``nvcc``
    each, all started together.  Returns ``{name: library path}``; the
    compiler's output lands in ``<library>.log``.  Raises with that
    output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, outs = {}, {}
    for name in names:
        cmd, out = _command(name)
        outs[name] = out
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd[cmd.index("-o") + 1] = str(tmp)
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode})\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
