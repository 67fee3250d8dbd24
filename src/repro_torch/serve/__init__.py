"""Serving-policy types around ``train.serve.Engine`` (port of
``repro/serve``: ``config``, ``request`` and ``metrics``; the traffic
harness and its telemetry come in a later slice).

  * ``config``  — ``ServeConfig``: pool shape, mixed-task scheduler,
                  admission control and the virtual clock.
  * ``request`` — ``Request`` (arrival in virtual seconds or decode steps).
  * ``metrics`` — ``RequestMetrics`` (TTFT/TPOT/queue-wait/e2e) and the
                  per-request ``ServeReport``.
"""
from repro_torch.serve.config import ServeConfig                       # noqa: F401
from repro_torch.serve.metrics import (RequestMetrics, ServeReport,    # noqa: F401
                                       percentiles, slo_summary)
from repro_torch.serve.request import Request                          # noqa: F401
