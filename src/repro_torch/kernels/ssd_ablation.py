"""Where the bf16 SSD scan's time goes, on the card: ``csrc/mamba_scan.cu``
rebuilt with one part of its work cut out at a time, and each variant
timed at the Jamba prefill's shape (b=1, s=32768, nh=8, dh=1024, N=16,
chunk 256, B and C strided, as ``chip_smoke.py`` times it).  A cut variant
computes a wrong y: its time says only what the part it lacks costs.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_ablation

Prints the card's name and power limit, then one JSON line a variant: the
call's time from CUDA events, each kernel's device time from
``torch.profiler``, and y's largest distance to the plain version in
units of the bf16 bar (at most 1 passes).  The unchanged source runs
first and last, so that the two say how far the times drift.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from repro_torch.kernels import _build, timing
from repro_torch.kernels import mamba_scan as MS

SHAPE = dict(b=1, s=32768, nh=8, dh=1024, N=16, chunk=256)
KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_chunk_scan_kernel")

_LO = ["        hopper::mma_16816(acc[2 * nd], lo, b[0], b[1]);\n",
       "        hopper::mma_16816(acc[2 * nd + 1], lo, b[2], b[3]);\n"]
_LOOP = "for (int j0 = 0; j0 <= i0; j0 += 16) {"
_STORE = ("*reinterpret_cast<uint32_t*>(yrow + ch) =\n"
          "                hopper::pack_bf16(v[0], v[1]);")
# name -> (text in the source, its replacement), applied in order
CUTS = {
    "as_built": [],
    "m_rounded_once": [(line, "") for line in _LO],
    "m_without_exp": [("(sc[tl][e] * expf(seg[i] - seg[j])) * dts[j]",
                       "sc[tl][e] * dts[j]")],
    "no_intra_products": [(_LOOP, "for (int j0 = 0; j0 < 0; j0 += 16) {")],
    "no_intra_products_no_y_store": [
        (_LOOP, "for (int j0 = 0; j0 < 0; j0 += 16) {"),
        (_STORE, "if (v[0] == 12345.0f) yrow[ch] = __float2bfloat16(v[1]);")],
}


def build(names) -> dict:
    """Each variant of ``csrc/mamba_scan.cu`` compiled with the flags of
    ``_build``, one ``nvcc`` each, all started together."""
    src = (_build.CSRC / "mamba_scan.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    base, _ = _build._command("mamba_scan")
    procs = {}
    for name in names:
        text = src
        for old, new in CUTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = list(base)
        cmd[cmd.index("-o") + 1] = str(lib)
        cmd[-1] = str(path)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = lib
    return libs


def kernel_ms(call, iters: int = 10) -> dict:
    """Mean device time of each of ``KERNELS`` a ``call()``, from
    ``timing.device_ms`` over ``iters`` calls."""
    seen = timing.device_ms(call, iters)
    out = {k: ms for key, (ms, _) in seen.items() for k in KERNELS
           if f"::{k}(" in key}
    if set(out) != set(KERNELS):
        raise AssertionError(f"the profiler saw {out}, not {KERNELS}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_ablation needs a CUDA card")
    card = timing.card_line()
    print(card, flush=True)
    order = list(CUTS) + ["as_built"]
    libs = build(CUTS)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, nh, dh, N, c = (SHAPE[k] for k in ("b", "s", "nh", "dh", "N",
                                              "chunk"))
    x = torch.randn(b, s, nh, dh, generator=g, device=dev).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn(b, s, nh, generator=g,
                                                  device=dev))
    A = -torch.exp(torch.randn(nh, generator=g, device=dev) * 0.5)
    bc = torch.randn(b, s, 2 * N, generator=g, device=dev).to(torch.bfloat16)
    D = torch.randn(nh, generator=g, device=dev)
    want, _ = MS.ssd_plain(x, dt, A, bc[..., :N], bc[..., N:], D, chunk=c)
    want = want.double()
    bar = 2e-2 * (want.square().mean().sqrt() + want.abs())

    def call():
        return MS.ssd_scan(x, dt, A, bc[..., :N], bc[..., N:], D, chunk=c)

    try:
        for name in order:
            _build._loaded["mamba_scan"] = ctypes.CDLL(str(libs[name]))
            y, _ = call()
            ratio = ((y.double() - want).abs() / bar).max().item()
            print(json.dumps({"variant": name, "card": card,
                              "ms": timing.cuda_ms(call, 20, warmup=3),
                              "kernel_ms": kernel_ms(call),
                              "y_over_bar": ratio}), flush=True)
    finally:
        _build._loaded.pop("mamba_scan", None)


if __name__ == "__main__":
    main()
