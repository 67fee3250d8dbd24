"""Command-line entry points of the port (``launch.serve``,
``launch.train``; port of ``repro/launch``' single-device paths)."""
