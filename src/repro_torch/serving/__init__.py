"""The continuous-batching serving engine of the port (``repro/serving``)."""
