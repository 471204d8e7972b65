"""Atomic checkpoints of the trainer and their lifecycle."""
