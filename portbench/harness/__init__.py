"""The harness: set-up, windows, traced blocks, comparisons."""
