"""The port's twins of the JAX package's evaluation drivers
(``benchmarks/``): one module a paper table or figure.

  characterization       — §3 workload statistics from generated traces
  mismatch               — §4 Table 2's three mismatches through replay
  engine_fig8            — Fig 8 on the live serving engine, three modes
  engine_overhead        — §6's in-step enforcement overhead on the engine
                           step, and the charge kernel against the plain
                           charge
  multitenant_isolation  — burst isolation, one shared table against one
                           shard a tenant; ``cpu.weight`` fairness
  throttle_precision     — §6's 2000 ms throttle selftest through the gate
  roofline_table         — the dry run's records as the roofline table
  run                    — the suite: every section in the source's order

The four replay drivers twinned earlier (``fig8_replay``,
``escalation_waste``, ``adaptive_pressure``, ``replay_traces``) live in
``repro_torch.traces``.  Each module prints its source's lines, returns
the values they print, keeps its assertions and gates, and runs as
``python -m repro_torch.evaluation.<name>`` with the source's flags; the
drivers that hold tensors run on the card unless ``--device cpu`` is
given, and the two engine drivers take ``--full`` (llama3.2-3b at full
width) and ``params=``.
"""
import torch


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (the sources'
    ``jax.block_until_ready``); nothing to wait for on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
