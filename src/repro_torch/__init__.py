"""PyTorch/CUDA port of the AgentCgroup reproduction (``src/repro``).

The JAX package stays the reference; this package mirrors its layout
module for module and imports neither JAX nor the JAX package.  Entry
points (``serving.engine.Engine``, ``core.cgroup.DeviceTableBackend``)
run on a CUDA card unless the caller passes ``device="cpu"``.  The
kernels under ``csrc/`` are built with ``nvcc`` on first use.
"""
