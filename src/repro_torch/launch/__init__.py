"""Command-line entry points of the port (``launch.serve``,
``launch.train``; port of ``repro/launch``' single-device paths), the dry
run over ``meta`` tensors (``launch.dryrun``, its counter
``launch.step_stats``) and the roofline over its records
(``launch.roofline``)."""
