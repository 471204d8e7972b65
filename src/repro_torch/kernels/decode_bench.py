"""The bf16 decode kernels' time on the card, cold, as the serving step
meets them: ``decode_attention`` and ``paged_decode_attention`` at the
heads of ``chip_smoke.py``'s engine_full (B 8, H 24, Hkv 8, d 128) at
the three shapes of ``SHAPES``: short agent contexts as engine_full's
sessions hold them (S_max 2048, 96-250 live keys a slot), caches filled
to ragged lengths up to the whole S_max of 2048 (7,201 live keys), and a
long context (S_max 32768, 123,787); the paged form in 16-token pages of
a permuted pool, -1 past each length.

    PYTHONPATH=src python -m repro_torch.kernels.decode_bench [--parent DIR] [--sweep]

Each call reads a different cache set, rotating over a shape's ``sets``
(28 at S_max 2048, as the engine's 28 layers; 2 at the long shape, whose
live bytes alone are ten times the 50 MB L2), so no call finds its K
and V in L2.  For each kernel: the device time a call from
``torch.profiler`` (every kernel the call launches, summed), the kernels
a call launches, and the issue pace (``timing.cuda_ms``); beside them
the bytes bound and, for the dense form, ``scaled_dot_product_attention``
(masked, GQA) timed the same way.  With ``--parent DIR`` the decode
wrapper and ``csrc/decode_attention.cu`` of another checkout at DIR are
built and timed in the same process, in turns (parent, this, this,
parent).  ``--sweep`` also times this checkout's dense kernel at each
cluster size (1, 2, 4, 8 CTAs per kv head and slot) at each shape and
with no live key (the fixed cost of a call).  Prints the card's name and
power limit, then one JSON line a measurement.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build, timing
from repro_torch.kernels.decode_attention import cost

HEADS = dict(B=8, H=24, hkv=8, d=128)
PAGE = 16
# name -> S_max, live keys a slot, cache sets a call rotates over, calls
# a measurement
SHAPES = {
    "short": dict(s_max=2048, lengths=[96, 150, 170, 200, 130, 250, 180,
                                       190], sets=28, calls=112),
    "filled": dict(s_max=2048,
                   lengths=[1, 2048, 37, 256, 257, 1000, 1555, 2047],
                   sets=28, calls=112),
    "long": dict(s_max=32768, lengths=[1, 32768, 4097, 16384, 20000, 30001,
                                       8191, 12345], sets=2, calls=20),
}


def bound(shape: str, paged: bool, heads: dict = HEADS) -> tuple[float, str]:
    """``timing.cost_bound_ms`` of ``decode_attention.cost`` for a bf16
    call at ``shape`` (with ``heads`` in place of engine_full's), at the
    shape's live lengths."""
    spec = SHAPES[shape]
    B, H, hkv, d = (heads[k] for k in ("B", "H", "hkv", "d"))
    meta = dict(dtype=torch.bfloat16, device="meta")
    q = torch.empty(B, H, d, **meta)
    if paged:
        npp = spec["s_max"] // PAGE
        kv = torch.empty(B * npp, PAGE, hkv, d, **meta)
        table = torch.empty(B, npp, dtype=torch.int32, device="meta")
        return timing.cost_bound_ms(cost(q, kv, kv, spec["lengths"], table,
                                         PAGE))
    kv = torch.empty(B, spec["s_max"], hkv, d, **meta)
    return timing.cost_bound_ms(cost(q, kv, kv, spec["lengths"]))


def cache_sets(shape: str, layout: str, dev, seed: int = 0,
               lengths=None, heads: dict = HEADS) -> list:
    """The shape's ``sets`` argument tuples of one decode call, each with
    its own q and cache: (q, k, v, lengths) dense or (q, k_pages,
    v_pages, table, lengths) paged, bf16, from a seeded generator on the
    card; ``lengths`` and ``heads`` in place of the shape's own and
    engine_full's, if given."""
    B, H, hkv, d = (heads[k] for k in ("B", "H", "hkv", "d"))
    spec = SHAPES[shape]
    s_max = spec["s_max"]
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.tensor(spec["lengths"] if lengths is None else lengths,
                           dtype=torch.int32, device=dev)
    out = []
    for _ in range(spec["sets"]):
        q = torch.randn(B, H, d, generator=g, device=dev).to(torch.bfloat16)
        if layout == "dense":
            k, v = (torch.randn(B, s_max, hkv, d, generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            out.append((q, k, v, lengths))
            continue
        npp = s_max // PAGE
        k, v = (torch.randn(B * npp, PAGE, hkv, d, generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        table = torch.randperm(B * npp, generator=g, device=dev).reshape(
            B, npp).to(torch.int32)
        first = torch.arange(npp, device=dev)[None] * PAGE
        table = torch.where(first < lengths[:, None], table,
                            torch.full_like(table, -1))
        out.append((q, k, v, table, lengths))
    return out


def measure(fn, sets: list, calls: int) -> dict:
    """``fn`` over the argument tuples ``sets`` in turn, after one
    untimed pass: the device time of every kernel launched and the
    kernels launched, a call (``timing.device_ms`` over ``calls``
    calls), and the issue pace (``timing.cuda_ms``)."""
    turn = itertools.cycle(sets)

    def call():
        return fn(*next(turn))

    for _ in sets:
        call()
    torch.cuda.synchronize()
    seen = timing.device_ms(call, calls)
    return {"device_ms": sum(ms for ms, _ in seen.values()),
            "kernels_per_call": sum(n for _, n in seen.values()),
            "kernels": sorted({key[:60] for key in seen}),
            "issue_ms": timing.cuda_ms(call, calls, warmup=len(sets))}


def library(q, k, v, lengths):
    """``scaled_dot_product_attention`` over the dense cache, masked at
    each length, with GQA: the same function; the port never calls it."""
    import torch.nn.functional as F

    mask = (torch.arange(k.shape[1], device=q.device)[None]
            < lengths[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True)[:, :, 0]


def load_parent(root: Path):
    """The decode wrapper module of the checkout at ``root`` and the
    library of its own ``csrc/decode_attention.cu``, built with this
    checkout's flags into ``build/kernels/parent/``.  The wrapper loads
    its library through this checkout's ``_build``, so a caller puts the
    library in ``_build._loaded`` while it times that wrapper."""
    src = root / "src" / "repro_torch" / "kernels" / "decode_attention.py"
    spec = importlib.util.spec_from_file_location("parent_decode", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = _build.BUILD_DIR / "parent" / "libdecode_attention.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd, _ = _build._command("decode_attention")
    cmd[cmd.index("-o") + 1] = str(out)
    cmd[-1] = str(root / "src" / "repro_torch" / "csrc" /
                  "decode_attention.cu")
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc of the parent's kernel:\n{done.stdout}"
                           f"{done.stderr}")
    return mod, ctypes.CDLL(str(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout to time beside this one")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the dense kernel at each cluster size")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench needs a CUDA card")
    from repro_torch.kernels import decode_attention as A

    card = timing.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    impls = {"this": (A, _build.load("decode_attention"))}
    if args.parent is not None:
        impls["parent"] = load_parent(args.parent)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    try:
        for shape, spec in SHAPES.items():
            for layout in ("dense", "paged"):
                sets = cache_sets(shape, layout, dev)
                runs = [(name, impls[name]) for name in order]
                if layout == "dense":
                    runs.append(("library", None))
                for turn, (name, impl) in enumerate(runs):
                    if impl is None:
                        fn = library
                    else:
                        mod, lib = impl
                        _build._loaded["decode_attention"] = lib
                        fn = mod.decode_attention if layout == "dense" \
                            else mod.paged_decode_attention
                    print(json.dumps({
                        "shape": shape, "layout": layout, "impl": name,
                        "turn": turn, "card": card,
                        "bound_ms": bound(shape, layout == "paged")[0],
                        **measure(fn, sets, spec["calls"])}), flush=True)
                del sets
                torch.cuda.empty_cache()
    finally:
        _build._loaded["decode_attention"] = impls["this"][1]
    if args.sweep:
        sweep(A, card, dev)


def sweep(A, card: str, dev) -> None:
    """The dense bf16 kernel at each cluster size, given to ``_run`` in
    place of ``_splits``'s choice, at each shape and with every slot
    empty."""
    cases = [(shape, None) for shape in SHAPES]
    cases.append(("empty", [0] * HEADS["B"]))
    for name, lens in cases:
        shape = "short" if name == "empty" else name
        sets = cache_sets(shape, "dense", dev, lengths=lens)
        for n in (1, 2, 4, 8):
            def call(q, k, v, lengths, n=n):
                return A._run(q, k, v, None, lengths, k.shape[1], 0,
                              k.shape[3], None, "decode_attention",
                              splits=n)

            print(json.dumps({"sweep": name, "splits": n, "card": card,
                              **measure(call, sets,
                                        SHAPES[shape]["calls"])}),
                  flush=True)
        del sets
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
