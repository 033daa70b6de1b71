"""The launchers' leveled stdout logger (port of ``repro.obs.log``).

One code path for every human-facing line the launcher prints -- the run
header and the round progress (via the ``stdout`` metrics sink) -- so
``--log-level`` / ``--quiet`` gate all of them uniformly.  Deliberately
tiny: module-level level state, ``print`` as the backend (no
logging-module handler machinery to configure per process).
"""
from __future__ import annotations

LEVELS = ("debug", "info", "warning", "error")

_LEVEL = ["info"]


def set_level(level: str) -> None:
    """Set the global threshold; messages below it are dropped."""
    if level not in LEVELS:
        raise ValueError(f"unknown log level {level!r}; choose from {LEVELS}")
    _LEVEL[0] = level


def get_level() -> str:
    return _LEVEL[0]


def log(msg: str, level: str = "info", **print_kw) -> None:
    """Print ``msg`` iff ``level`` clears the global threshold."""
    if level not in LEVELS:
        raise ValueError(f"unknown log level {level!r}; choose from {LEVELS}")
    if LEVELS.index(level) >= LEVELS.index(_LEVEL[0]):
        print(msg, **print_kw)
