"""The port's dry run and roofline on one H100 (``launch/dryrun.py``,
``analysis/costs.py``, ``analysis/roofline.py``, ``launch/mesh.py``) and
the kernels' ``cost`` functions and no-data branches.

Against the JAX package: ``cell_applicability``, ``model_flops`` and
``roofline_from_costs`` (the reference's ``HW`` patched to the port's
table) equal for all 40 arch x shape cells, and the counter's flops for a
scan-free product equal ``repro.analysis.hlo.analyze``'s.  Each kernel's
``cost`` reproduces PERF.md's bounds to the digits given there.  A
reduced llama3.2-3b forward counts its analytic flops; the peak tracker
holds a hand count of parameters, gradients and AdamW moments exactly;
at full width llama3.2-3b's train_4k at batch 1 fits the card's 80 GB
(56 flash forwards and 28 backwards, as the card's step launches them)
and a one-layer deepseek-v2-236b's does not (the card ran out of memory
at 74.93 GB).  Meta and fake tensors never reach ``_build.load``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_leaves, tree_map

from repro.analysis import roofline as JR
from repro.analysis.hlo import analyze
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs.base import cell_applicability as j_cell_applicability
from repro_torch import configs as TC
from repro_torch.analysis import roofline as TR
from repro_torch.analysis.costs import CostCounter, block_bytes
from repro_torch.configs.base import cell_applicability
from repro_torch.core.cgroup import (AgentCgroup, DeviceTableBackend,
                                     DomainSpec)
from repro_torch.core.progs import GraduatedThrottleProgram
from repro_torch.kernels import _build, launch_counts, timing
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import decode_bench as DB
from repro_torch.kernels import enforcement as EN
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import HW
from repro_torch.models import model as TM
from repro_torch.perf import DEFAULT_PERF
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.training.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
META = dict(device="meta", dtype=torch.bfloat16)
CELLS = [(a, s) for a in TC.ARCH_IDS for s in TC.SHAPES]


def test_hardware_table_is_the_cards_and_timing_reads_it():
    assert (HW["flops_bf16"], HW["flops_f32"], HW["hbm_bw"],
            HW["hbm_bytes"]) == (989e12, 67e12, 3.35e12, 80e9)
    assert timing.MEM_BYTES_PER_S == HW["hbm_bw"]
    assert timing.PEAK_OPS_PER_S == {torch.bfloat16: 989e12,
                                     torch.float32: 67e12}


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_rules_and_roofline_match_reference(arch, shape, monkeypatch):
    """cell_applicability, model_flops and roofline_from_costs of the
    port against the reference's, the reference's HW patched to the
    port's table (no collective: its link rates never divide a byte)."""
    cfg, jcfg = TC.get_config(arch), j_get_config(arch)
    sh, jsh = TC.SHAPES[shape], J_SHAPES[shape]
    assert cell_applicability(cfg, sh) == j_cell_applicability(jcfg, jsh)
    assert TR.model_flops(cfg, sh) == JR.model_flops(jcfg, jsh)
    monkeypatch.setattr(JR, "HW", dict(HW, ici_bw=1.0, dcn_bw=1.0))
    for flops, byts in ((3.7e15, 2.1e12), (1.0e9, 4.4e12)):
        parsed = {"flops": flops, "bytes": byts, "coll_bytes_total": 0.0,
                  "coll_dcn_bytes": 0.0}
        assert TR.roofline_from_costs(cfg, sh, parsed, n_chips=1) == \
            JR.roofline_from_costs(jcfg, jsh, parsed, n_chips=1)


def test_counter_flops_match_hlo_analyze_without_scan():
    """As tests/test_analysis.py:48: (64 x 128) @ (128 x 32), summed."""
    def f(a, b):
        return (a @ b).sum()
    txt = jax.jit(f).lower(jnp.ones((64, 128)), jnp.ones((128, 32))) \
        .compile().as_text()
    want = analyze(txt)["flops"]
    with CostCounter() as cc:
        f(torch.empty(64, 128, device="meta"),
          torch.empty(128, 32, device="meta"))
    assert cc.flops == want == 2 * 64 * 128 * 32
    assert cc.result()["coll_bytes_total"] == 0.0


# PERF.md's kernel table: each bound as written there, from the shapes of
# chip_smoke.py's checks
def _flash(B, S, H, hkv, dk, dv=None):
    dv = dv or dk
    return (torch.empty(B, S, H, dk, **META),
            torch.empty(B, S, hkv, dk, **META),
            torch.empty(B, S, hkv, dv, **META))


FLASH_BOUNDS = [
    ("fwd_llama", (1, 4096, 24, 8, 128), True, False, "0.1042"),
    ("fwd_prefill", (1, 32768, 32, 8, 128), True, False, "8.894"),
    ("fwd_pixtral", (1, 4096, 32, 8, 160), True, False, "0.1737"),
    ("fwd_hubert", (1, 4096, 16, 16, 80), False, False, "0.0869"),
    ("fwd_mla", (1, 4096, 128, 128, 192, 128), True, False, "0.6948"),
    ("bwd_llama", (1, 4096, 24, 8, 128), True, True, "0.2606"),
    ("bwd_pixtral", (1, 4096, 32, 8, 160), True, True, "0.4343"),
    ("bwd_hubert", (1, 4096, 16, 16, 80), False, True, "0.2171"),
    ("bwd_mla", (1, 4096, 128, 128, 192, 128), True, True, "1.8066"),
]


def same_digits(x: float, written: str) -> bool:
    """``x`` rounded to the significant digits of ``written``."""
    n = len(written.replace(".", "").lstrip("0"))
    return f"{x:.{n}g}" == f"{float(written):.{n}g}"


@pytest.mark.parametrize("name,shape,causal,backward,want", FLASH_BOUNDS,
                         ids=[c[0] for c in FLASH_BOUNDS])
def test_flash_cost_gives_perf_bounds(name, shape, causal, backward, want):
    cost = FA.cost(*_flash(*shape), causal=causal, backward=backward)
    ms, by = timing.cost_bound_ms(cost)
    assert same_digits(ms, want) and by == "operations", (ms, want)


# the examples' f32 training shapes (chip_smoke.py FLASH_EXAMPLES): d 32
# is bound by its bytes, d 64 by its operations at the f32 peak
FLASH_F32_BOUNDS = [
    ("fwd_quickstart", (4, 64, 4, 2, 32), False, "0.0001186", "bytes"),
    ("bwd_quickstart", (4, 64, 4, 2, 32), True, "0.0002360", "bytes"),
    ("fwd_train100m", (8, 256, 8, 4, 64), False, "0.008013", "operations"),
    ("bwd_train100m", (8, 256, 8, 4, 64), True, "0.02003", "operations"),
]


@pytest.mark.parametrize("name,shape,backward,want,by", FLASH_F32_BOUNDS,
                         ids=[c[0] for c in FLASH_F32_BOUNDS])
def test_flash_f32_cost_gives_perf_bounds(name, shape, backward, want, by):
    B, S, H, hkv, d = shape
    f32 = dict(device="meta", dtype=torch.float32)
    q, k, v = (torch.empty(B, S, h, d, **f32) for h in (H, hkv, hkv))
    ms, got_by = timing.cost_bound_ms(FA.cost(q, k, v, causal=True,
                                              backward=backward))
    assert same_digits(ms, want) and got_by == by, (ms, want, got_by)


def test_ssd_cost_gives_perf_bound():
    b, s, nh, dh, N = 1, 32768, 8, 1024, 16
    f32 = dict(device="meta", dtype=torch.float32)
    cost = MS.cost(torch.empty(b, s, nh, dh, **META),
                   torch.empty(b, s, nh, **f32), torch.empty(nh, **f32),
                   torch.empty(b, s, N, **META), torch.empty(b, s, N, **META),
                   torch.empty(nh, **f32), chunk=256)
    ms, by = timing.cost_bound_ms(cost)
    assert same_digits(ms, "0.3219") and by == "bytes", ms


@pytest.mark.parametrize("shape,want", [("short", "0.00170"),
                                        ("filled", "0.00883"),
                                        ("long", "0.1514")])
def test_decode_cost_gives_perf_bounds(shape, want):
    spec = DB.SHAPES[shape]
    B, H, hkv, d = (DB.HEADS[k] for k in ("B", "H", "hkv", "d"))
    kv = torch.empty(B, spec["s_max"], hkv, d, **META)
    cost = DA.cost(torch.empty(B, H, d, **META), kv, kv, spec["lengths"])
    ms, by = timing.cost_bound_ms(cost)
    assert same_digits(ms, want) and by == "bytes", ms
    assert DB.bound(shape, False) == (ms, by)
    # without lengths: the whole cache, as a dry run's decode cell
    full = DA.cost(torch.empty(B, H, d, **META), kv, kv)
    assert full == DA.cost(torch.empty(B, H, d, **META), kv, kv,
                           [spec["s_max"]] * B)


ENFORCEMENT_BOUNDS = [("engine", "9.07e-7", "7.10e-8"),
                      ("wide", "3.80e-5", "2.57e-6"),
                      ("beyond", "1.51e-4", "1.02e-5"),
                      ("groups", "1.39e-4", "1.35e-6"),
                      ("spread", "2.83e-4", "5.23e-6")]


@pytest.mark.parametrize("shape,charge,gate", ENFORCEMENT_BOUNDS,
                         ids=[c[0] for c in ENFORCEMENT_BOUNDS])
def test_enforcement_cost_gives_perf_bounds(shape, charge, gate):
    """The charge's and gate's cost at each bench shape's data (the
    chains its slots walk) gives PERF.md's bounds."""
    from repro_torch.kernels import enforcement_bench as EB

    case = (EB.shape_case if shape in EB.SHAPES else EB.shard_case)
    st, dom = case(shape, "cpu", 0)[:2]
    walks = EB.walks(st, dom)
    for cost, want in ((EN.charge_cost(st, dom, walks), charge),
                       (EN.gate_cost(st, dom, walks), gate)):
        ms, by = timing.cost_bound_ms(cost)
        assert by == "bytes" and f"{ms:.2e}" == f"{float(want):.2e}", ms
    # without the chains: every slot walks the whole depth, an upper bound
    assert EN.charge_cost(st, dom)["bytes"] >= \
        EN.charge_cost(st, dom, walks)["bytes"]


def _analytic_forward_flops(cfg, B, S):
    """The products of a dense GQA forward, and the flash forward's
    2 (dk + dv) flops a causal pair and head."""
    d, hd, H, hkv = cfg.d_model, cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    T = B * S
    layer = 2 * T * (d * H * hd + 2 * d * hkv * hd + H * hd * d
                     + 3 * d * cfg.d_ff)
    flash = 2 * (B * H * S * S / 2) * (2 * hd)
    return cfg.n_layers * (layer + flash) + 2 * T * d * cfg.padded_vocab


def test_reduced_llama_forward_counts_its_analytic_flops():
    cfg = TC.reduced(TC.get_config("llama3.2-3b"))
    B, S = 2, 64
    with CostCounter() as cc, torch.no_grad():
        params = DR.meta_params(cfg)
        tokens = torch.empty(B, S, dtype=torch.int32, device="meta")
        cc.reset()
        logits, _ = TM.forward(cfg, params, {"tokens": tokens})
    assert tuple(logits.shape) == (B, S, cfg.padded_vocab)
    assert cc.flops == _analytic_forward_flops(cfg, B, S)
    assert cc.kernels["flash_fwd"]["launches"] == cfg.n_layers


def test_peak_tracker_holds_params_grads_and_moments():
    """On the reduced f32 llama: parameters, gradients and the two f32
    AdamW moments (and the step count) are exactly their storages, each
    rounded to 512 bytes; a train step's peak holds all of them, split
    by tag, and the step's storages are all freed after it."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("llama3.2-3b")),
                              dtype="float32")
    with CostCounter() as cc:
        params = DR.meta_params(cfg)
        P = sum(block_bytes(t.numel() * 4) for t in tree_leaves(params))
        opt = init_train_state(cfg, params)
        grads = tree_map(torch.empty_like, params)
        assert cc.live == P + P + 2 * P + block_bytes(4)
        adamw_update(grads, opt, params, 1e-3, OptConfig())
        assert cc.peak >= 4 * P + block_bytes(4)
        del grads
        cc.tag(params, "params")
        cc.tag(opt, "optimizer")
        cc.reset()
        batch = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
                 for k, (s, d) in DR.batch_leaves(cfg, "train", 1,
                                                  8).items()}
        step = make_train_step(cfg, DEFAULT_PERF)
        step(params, opt, batch, 0)
        res = cc.result()
        assert res["peak_by_tag"]["params"] == P
        assert res["peak_by_tag"]["optimizer"] == 2 * P + block_bytes(4)
        # the gradients live beside the parameters and the moments
        assert res["peak_by_tag"]["rest"] >= P
        assert res["peak_bytes"] == sum(res["peak_by_tag"].values())


def test_llama_train_cell_fits_the_card_from_the_command_line(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape
    train_4k --batch 1`` on the CPU: the record's peak fits 80 GB, its
    roofline terms, and the flash calls a card's step launches."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "train_4k", "--batch", "1", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec == json.loads(
        (tmp_path / "llama3.2-3b__train_4k__batch1.json").read_text())
    mem = rec["memory"]
    assert mem["fits_hbm"] and 40e9 < mem["per_device_bytes"] <= 80e9
    assert mem["at_peak"]["params"] == sum(
        block_bytes(t.numel() * 2) for t in tree_leaves(
            DR.meta_params(TC.get_config("llama3.2-3b"))))
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == {
        "flash_fwd": 56, "flash_bwd": 28}
    assert rec["reduced"] == {"global_batch": "256 -> 1"}
    assert rec["microbatches"].startswith("2 -> 1")
    roof = rec["roofline"]
    assert roof["collective_s"] == 0.0
    assert roof["step_time_bound_s"] == max(roof["compute_s"],
                                            roof["memory_s"])
    assert roof["compute_s"] == rec["costs"]["flops"] / HW["flops_bf16"]


def test_one_layer_deepseek_train_cell_does_not_fit():
    rec = DR.run_cell("deepseek-v2-236b", "train_4k", layers=1, batch=1)
    assert rec["reduced"]["n_layers"] == "60 -> 1"
    assert not rec["memory"]["fits_hbm"]
    assert rec["memory"]["per_device_bytes"] > 80e9
    assert rec["perf"]["remat"] == "full"


def test_decode_and_prefill_cells_trace_their_kernels():
    """A decode cell: one decode call a GQA layer, against the whole
    cache, which is exactly the state's storages; a cut Jamba prefill:
    7 SSD scans and 1 flash forward a group."""
    rec = DR.run_cell("llama3.2-3b", "decode_32k", batch=8, seq=4096)
    cfg = TC.get_config("llama3.2-3b")
    dec = rec["kernels"]["decode_attention"]
    assert dec["launches"] == cfg.n_layers
    cache = 2 * block_bytes(cfg.n_layers * 8 * 4096 * cfg.n_kv_heads
                            * cfg.head_dim_ * 2)
    at_peak = rec["memory"]["at_peak"]
    assert at_peak["state"] == cache
    # the kernel reads the whole cache once; writing the new token's row
    # counts the row (a scatter's update), not the cache: the step's
    # bytes are the weights, the kernel's and little else
    assert dec["bytes"] > 0.9 * cache
    assert rec["costs"]["bytes"] < 1.05 * at_peak["params"] + dec["bytes"]
    rec = DR.run_cell("jamba-v0.1-52b", "prefill_32k", layers=8, batch=1,
                      seq=512)
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == {
        "ssd_scan": 7, "flash_fwd": 1}
    assert DR.run_cell("jamba-v0.1-52b", "train_4k", layers=8, batch=1,
                       seq=512)["unsupported"].startswith("jamba")
    assert not DR.run_cell("hubert-xlarge", "decode_32k")["applicable"]


def _table(n_domains=64):
    cg = AgentCgroup(DeviceTableBackend(1 << 20, n_domains=n_domains,
                                        device="cpu"))
    cg.attach("/", GraduatedThrottleProgram())
    cg.mkdir("/a", DomainSpec(high=1000))
    return cg, {k: v.to("meta") for k, v in cg.device_view().state.items()}


def test_no_data_never_reaches_the_kernel_build(monkeypatch):
    """Every wrapper on meta tensors (and the flash forward on fake CUDA
    tensors) allocates its outputs, reports its cost and launches
    nothing: ``_build.load`` is never called and no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(name):
        raise AssertionError(f"_build.load({name!r}) on tensors without data")
    monkeypatch.setattr(_build, "load", refuse)
    before = launch_counts()
    with CostCounter() as cc:
        q, k, v = _flash(2, 64, 4, 2, 32)
        out, lse = FA.flash_fwd(q, k, v)
        assert (out.shape, lse.shape, lse.dtype) == (
            q.shape, (2, 4, 64), torch.float32)
        dq, dk, dv = FA.flash_bwd(q, k, v, out, lse, out)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
        for dtype in (torch.bfloat16, torch.float32):
            qd = torch.empty(8, 24, 128, device="meta", dtype=dtype)
            kv = torch.empty(8, 256, 8, 128, device="meta", dtype=dtype)
            lengths = torch.empty(8, dtype=torch.int32, device="meta")
            assert DA.decode_attention(qd, kv, kv, lengths).shape == qd.shape
            pages = torch.empty(128, 16, 8, 128, device="meta", dtype=dtype)
            table = torch.empty(8, 16, dtype=torch.int32, device="meta")
            assert DA.paged_decode_attention(qd, pages, pages, table,
                                             lengths).shape == qd.shape
        f32 = dict(device="meta", dtype=torch.float32)
        y, h = MS.ssd_scan(torch.empty(1, 512, 2, 64, **META),
                           torch.empty(1, 512, 2, **f32),
                           torch.empty(2, **f32),
                           torch.empty(1, 512, 16, **META),
                           torch.empty(1, 512, 16, **META),
                           torch.empty(2, **f32))
        assert (y.shape, h.shape) == ((1, 512, 2, 64), (1, 2, 64, 16))
        cg, state = _table()
        dom = torch.empty(8, dtype=torch.int32, device="meta")
        new, granted, stalled = EN.fused_charge_batch(
            state, dom, dom, 3, cg.programs)
        assert new["usage"].shape == state["usage"].shape
        assert granted.shape == stalled.shape == (8,)
        assert EN.fused_slot_gate(state, dom, 3, cg.programs).shape == (8,)
    assert {k: v["launches"] for k, v in cc.kernels.items()} == {
        "flash_fwd": 1, "flash_bwd": 1, "decode_attention": 2,
        "paged_decode_attention": 2, "ssd_scan": 1,
        "fused_charge_batch": 1, "fused_slot_gate": 1}
    assert cc.kernels["fused_charge_batch"]["bytes"] == \
        EN.charge_cost(state, dom)["bytes"]
    with FakeTensorMode():
        q, k, v = (torch.empty(1, 64, 4, 32, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        out, lse = FA.flash_fwd(q, k, v)
        assert out.device.type == "cuda" and out.shape == q.shape
    assert launch_counts() == before


def test_enforcement_roofline_keeps_the_reference_record():
    rec = TR.enforcement_roofline()
    assert {"n_domains", "batch", "n_programs", "lax", "fused",
            "bytes_ratio"} <= set(rec)
    for route in ("lax", "fused"):
        assert set(rec[route]) == {"flops", "bytes", "compute_s",
                                   "memory_s"}
        assert rec[route]["memory_s"] == rec[route]["bytes"] / HW["hbm_bw"]
    assert 0 < rec["bytes_ratio"] < 1
    assert TR.fmt_seconds(2.5) == JR.fmt_seconds(2.5) == "2.50s"
    assert TR.fmt_seconds(3e-4) == JR.fmt_seconds(3e-4)
