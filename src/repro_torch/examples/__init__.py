"""The port's twins of the JAX package's ``examples/`` drivers.

  quickstart    — the control plane on host, device and async backends,
                  a reduced llama trained 10 steps, two sessions served
                  under AgentCgroup (``examples/quickstart.py``)
  serve_agents  — trace-derived agent sessions served in the three
                  controller modes (``examples/serve_agents.py``);
                  ``--full`` serves the arch at full width
  train_100m    — a ~100M-parameter llama-family model trained with
                  checkpoints, the cosine schedule and optional int8
                  gradient compression (``examples/train_100m.py``)

Each prints its source's lines, returns the values they print, and runs
on the card unless ``--device cpu`` is given:
``python -m repro_torch.examples.<name> [--device cpu]``.  The twins'
``main`` takes the model's parameters as an argument (``params=``) so a
test can carry the reference's weights across (``params_from_jax``);
from the command line each draws its own from a seeded generator.
"""
