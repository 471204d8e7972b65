"""Benchmark suite entry point — one section per paper table/figure:

  characterization   §3 Figs 1-7 / Table 1 (workload statistics)
  mismatch           §4 Table 2 (granularity/responsiveness/adaptability)
  fig8_replay        §6 Fig 8 (trace replay: survival + P95 latency)
  escalation_waste   §6 semantic OOM escalation (retry completion + waste)
  adaptive_pressure  §4/§5 PSI-driven soft-limit retuner vs static limits
  engine_fig8        beyond-paper: Fig 8 on the live serving engine
  multitenant_isolation  cpu.weight proportional share vs uniform gate
  throttle_precision §6 kernel-selftest analogue (2000 ms +/- 2.3%)
  roofline_table     dry-run roofline baselines (if build/dryrun present)

Port of ``benchmarks/run.py`` as a module of the port: the same
sections in the same order with the same arguments, through the twins
of ``repro_torch.evaluation`` and the four replay drivers of
``repro_torch.traces``.  ``--device`` goes to every section that holds
tensors (the card unless ``--device cpu``), ``--full`` to the two engine
sections (llama3.2-3b at full width); ``run`` returns each section's
result by name.

Run: PYTHONPATH=src python -m repro_torch.evaluation.run [--full] \\
         [--device cpu]
"""
import argparse
import os
import time


def run(device="cuda", full: bool = False, params=None,
        dryrun_dir=None) -> dict:
    """Every section in order; ``params`` (llama3.2-3b's weights at the
    width ``full`` asks for; each engine section draws its own when not
    given) serves both engine sections, and
    ``dryrun_dir`` (default ``roofline_table.OUT_DIR``) holds the dry
    run's records."""
    t0 = time.perf_counter()
    from repro_torch.evaluation import (characterization, engine_fig8,
                                        engine_overhead, mismatch,
                                        multitenant_isolation,
                                        roofline_table, throttle_precision)
    from repro_torch.traces import (adaptive_pressure, escalation_waste,
                                    fig8_replay)
    from repro_torch.core.controller import resolve_device

    dev = resolve_device(device)
    engine = dict(device=dev, full=full, params=params)
    out = {}
    out["characterization"] = characterization.run()
    out["mismatch"] = mismatch.run()
    out["fig8_replay"] = fig8_replay.run()
    out["escalation_waste"] = escalation_waste.run(n=4)
    out["adaptive_pressure"] = adaptive_pressure.run(n=4)
    out["engine_fig8"] = engine_fig8.run(**engine)
    out["engine_overhead"] = engine_overhead.run(**engine)
    out["multitenant_isolation"] = multitenant_isolation.run(device=dev)
    out["throttle_precision"] = throttle_precision.run(device=dev)
    dryrun_dir = dryrun_dir or roofline_table.OUT_DIR
    if os.path.isdir(dryrun_dir):
        out["roofline_table"] = roofline_table.run(dryrun_dir)
    else:
        print(f"\n({os.path.relpath(dryrun_dir)} missing — run "
              "`python -m repro_torch.launch.dryrun --all` for roofline "
              "tables)")
    print(f"\nbenchmarks done in {time.perf_counter() - t0:.1f}s")
    return out


def main(argv=None, params=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the engine sections at llama3.2-3b's full width "
                         "(bf16, seeded random weights)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device, full=args.full, params=params)


if __name__ == "__main__":
    main()
