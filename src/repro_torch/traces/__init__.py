"""Agent-workload traces and their replay (port of ``repro/traces``).

  schema     — ``TaskTrace``/``ToolCall`` and the alloc-event conversion
  generator  — synthetic traces calibrated to the paper's §3 statistics
  replay     — the multi-tenant trace-replay simulator (paper §6)

The paper's replay drivers run as modules of this package:
``fig8_replay`` (Fig 8), ``replay_traces`` (Table 2's baselines),
``escalation_waste`` and ``adaptive_pressure``.
"""
