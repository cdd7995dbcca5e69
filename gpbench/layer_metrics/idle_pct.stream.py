"""Share of the traced window of a streamed SVGP fit in which no operation
ran on the device (profiler; layer: the device), read as ``idle_pct.fit``
reads it."""

from harness.manifest import load_module

read = load_module("layer_metrics", "idle_pct.fit.py").read
