"""repro_torch.obs -- observability (port of ``repro.obs``).

* :mod:`repro_torch.obs.bus`    -- the telemetry bus: a typed
  :class:`Telemetry` record of optimizer-health counters riding the round
  metrics (``RoundMetrics.telemetry``), gated by
  :class:`repro_torch.configs.base.ObsConfig` -- disabled is the plain
  engine, bit for bit.
* :mod:`repro_torch.obs.trace`  -- stage-level tracing:
  ``torch.profiler.record_function`` spans around the round stages, the
  wire call sites and the kernel launches, plus :class:`ProfileWindow`
  (the launcher's ``--profile start:stop`` capture).
* :mod:`repro_torch.obs.sinks`  -- the :class:`MetricsSink` registry
  (memory / jsonl / stdout) the launcher reports through;
  :mod:`repro_torch.obs.log` is the leveled stdout logger behind its
  ``--log-level``.
"""
from repro_torch.obs.bus import (Telemetry, empty_telemetry,  # noqa: F401
                                 residual_norm, ring_init, round_telemetry,
                                 staleness_hist, window_wrap)
# NB: the `log` *function* is not re-exported at package level -- it would
# shadow the `repro_torch.obs.log` submodule attribute and break
# `from repro_torch.obs import log as obs_log` in the launcher.
from repro_torch.obs.log import get_level, set_level  # noqa: F401
from repro_torch.obs.sinks import (MetricsSink, get_sink,  # noqa: F401
                                   register_sink, rows, sink_names)
from repro_torch.obs.trace import ProfileWindow, stage  # noqa: F401

__all__ = [
    "Telemetry", "empty_telemetry", "residual_norm", "ring_init",
    "round_telemetry", "staleness_hist", "window_wrap",
    "MetricsSink", "get_sink", "register_sink", "rows", "sink_names",
    "ProfileWindow", "stage", "set_level", "get_level",
]
