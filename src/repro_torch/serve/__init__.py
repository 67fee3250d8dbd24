"""The serving layer around ``train.serve.Engine`` (port of
``repro/serve``):

  * ``config``    — ``ServeConfig``: pool shape, mixed-task scheduler,
                    admission control and the virtual clock.
  * ``request``   — ``Request`` (arrival in virtual seconds or decode
                    steps) and trace (de)serialization.
  * ``metrics``   — ``RequestMetrics`` (TTFT/TPOT/queue-wait/e2e) and the
                    per-request ``ServeReport``.
  * ``traffic``   — seeded Poisson and trace-replay arrival processes.
  * ``telemetry`` — ``MetricSink`` and its stable schema-1 document.
  * ``driver``    — the harness entry: traffic → ``Engine.serve`` → SLO
                    summaries → telemetry.
"""
from repro_torch.serve.config import ServeConfig                       # noqa: F401
from repro_torch.serve.metrics import (RequestMetrics, ServeReport,    # noqa: F401
                                       percentiles, slo_summary)
from repro_torch.serve.request import Request                          # noqa: F401
from repro_torch.serve import driver, telemetry, traffic               # noqa: F401
