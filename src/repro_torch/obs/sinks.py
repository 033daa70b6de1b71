"""The MetricsSink registry (port of ``repro.obs.sinks``).

A sink class registers under its ``name``, :func:`get_sink` instantiates
by name, and the launcher reports through whichever sink ``--sink``
selects:

* ``memory`` -- records accumulate in ``sink.records`` (tests, notebooks),
* ``jsonl``  -- one JSON object per round appended to a file (the
  machine-readable run log; the reference's record schema),
* ``stdout`` -- the live dashboard line, through :mod:`repro_torch.obs.log`
  so ``--quiet`` gates it.

:func:`rows` turns a drive loop's stacked host metrics (RoundMetrics or
AsyncMetrics, telemetry included when enabled) into the per-round dict
records the sinks consume -- one flat namespace: round scalars verbatim,
async counters verbatim, telemetry prefixed ``tel_`` (the staleness
histogram stays a list).
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from repro_torch.obs import log as obs_log

_SINKS: dict = {}


def register_sink(cls):
    """Class decorator: register a MetricsSink under its ``name``."""
    _SINKS[cls.name] = cls
    return cls


def get_sink(name: str, **kw) -> "MetricsSink":
    try:
        cls = _SINKS[name]
    except KeyError:
        raise ValueError(f"unknown metrics sink {name!r}; "
                         f"registered: {sorted(_SINKS)}") from None
    return cls(**kw)


def sink_names() -> tuple:
    return tuple(sorted(_SINKS))


class MetricsSink:
    """One destination for per-round metric records.

    Law: ``open(meta)`` once before the run (run-level metadata),
    ``emit(record)`` once per round with a flat JSON-able dict, ``close()``
    once after.  Sinks never mutate records and tolerate missing keys --
    the sync engine emits no async counters, a disabled-telemetry run no
    ``tel_*`` keys."""

    name: str = "?"

    def open(self, meta: Optional[dict] = None) -> None:
        pass

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


@register_sink
class MemorySink(MetricsSink):
    """Records accumulate in ``self.records`` (and ``self.meta``)."""

    name = "memory"

    def __init__(self):
        self.records: list = []
        self.meta: Optional[dict] = None

    def open(self, meta: Optional[dict] = None) -> None:
        self.meta = meta

    def emit(self, record: dict) -> None:
        self.records.append(dict(record))


@register_sink
class JsonlSink(MetricsSink):
    """One JSON object per line; the opening ``meta`` (when given) is the
    first line under a ``"meta"`` key so a reader can split it off."""

    name = "jsonl"

    def __init__(self, path: str = "metrics.jsonl"):
        self.path = path
        self._f = None

    def open(self, meta: Optional[dict] = None) -> None:
        self._f = open(self.path, "a")
        if meta:
            self._f.write(json.dumps({"meta": meta}) + "\n")

    def emit(self, record: dict) -> None:
        if self._f is None:
            self.open()
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


@register_sink
class StdoutSink(MetricsSink):
    """The live dashboard: one progress line per record through
    :mod:`repro_torch.obs.log` (level ``info``, so ``--quiet`` silences
    it).  Core fields first, then whatever diagnostics the record
    carries."""

    name = "stdout"

    def emit(self, record: dict) -> None:
        r = dict(record)
        parts = [f"round {int(r.pop('round', 0)):4d}:"]
        for key, fmt in (("f", "f={:.4f}"), ("g_hat", "g={:+.4f}"),
                         ("sigma", "sigma={:.2f}")):
            if key in r:
                parts.append(fmt.format(float(r.pop(key))))
        if "s_per_round" in r:
            parts.append(f"({float(r.pop('s_per_round')):.2f}s/round)")
        for key, fmt in (("occupancy", "buffered={:.0f}"),
                         ("merged", "merged={:.0f}"),
                         ("tel_margin", "margin={:+.4f}"),
                         ("tel_switch_frac", "switch={:.2f}"),
                         ("tel_up_ratio", "ef_ratio={:.3f}")):
            if key in r:
                parts.append(fmt.format(float(r[key])))
        obs_log.log(" ".join(parts))


# ---------------------------------------------------------------------------
# Stacked host metrics -> per-round sink records
# ---------------------------------------------------------------------------

_ROUND_KEYS = ("f", "g_hat", "g_full", "sigma", "feasible", "delta_norm",
               "up_bytes", "down_bytes", "f_full")
_ASYNC_KEYS = ("fresh", "departed", "merged", "dropped", "occupancy",
               "fresh_weight", "departed_weight", "stale_weight",
               "dropped_weight", "buffered_weight", "max_age")


def _py(x):
    a = np.asarray(x)
    if a.ndim == 0:
        return a.item()
    return a.tolist()


def rows(metrics, start_round: int = 0,
         s_per_round: Optional[float] = None) -> list:
    """Per-round records from a drive loop's stacked host metrics (``[T]``
    leading axis numpy; RoundMetrics or AsyncMetrics).  ``start_round``
    offsets the ``round`` field (later chunks); ``s_per_round`` stamps
    wall-clock."""
    rm = metrics.round if hasattr(metrics, "round") else metrics
    T = int(np.asarray(rm.f).shape[0])
    out = []
    for t in range(T):
        rec = {"round": start_round + t + 1}
        for key in _ROUND_KEYS:
            rec[key] = _py(getattr(rm, key)[t])
        if metrics is not rm:
            for key in _ASYNC_KEYS:
                rec[key] = _py(getattr(metrics, key)[t])
        tel = getattr(rm, "telemetry", None)
        if tel is not None:
            for key, val in tel._asdict().items():
                rec["tel_" + key] = _py(val[t])
        if s_per_round is not None:
            rec["s_per_round"] = float(s_per_round)
        out.append(rec)
    return out
