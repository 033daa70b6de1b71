"""Stage-level tracing (port of ``repro.obs.trace``).

:func:`stage` is the one span primitive of the package: a
``torch.profiler.record_function`` range around a round stage, a wire call
site or a kernel launch.  It records metadata only -- no sync, no change to
any value -- so the engine wraps its stages unconditionally.  Under a
profiler each span shows on the host timeline, and the kernels launched
inside it on the device timeline, under the span's name; without one the
span costs one dispatcher call on enter and one on exit.

Span time is host time: a span brackets the launches, not the kernels.
The device time of a stage is that of the kernels launched inside its span
(``chip_smoke.py`` reports both).

:class:`ProfileWindow` backs the launcher's ``--profile start:stop``: it
runs ``torch.profiler.profile`` while the round counter is inside the
window and writes a Chrome/Perfetto trace when it leaves (view at
https://ui.perfetto.dev or ``chrome://tracing``).
"""
from __future__ import annotations

import os

import torch


def stage(name: str):
    """A named tracing span (a context manager); metadata only."""
    return torch.profiler.record_function(name)


class ProfileWindow:
    """Capture a profiler trace for a window of rounds.

    ``spec`` is ``"start:stop"`` in round numbers (capture while ``start
    <= round < stop``), e.g. ``--profile 10:20``; ``""``/None disables
    (every call is a no-op).  Drive it from the training loop with
    :meth:`tick` (chunked drive loops may tick at chunk granularity)::

        >>> win = ProfileWindow("10:20", out_dir="profiles")
        >>> for chunk in range(...):
        ...     win.tick(done_rounds)      # starts/stops as the window
        ...     state, hist = drive(...)   # boundary is crossed
        >>> win.close()                    # stop if still capturing

    The trace goes to ``<out_dir>/trace_<start>_<stop>.json`` (``path``).
    The device's activity is captured when a card is present."""

    def __init__(self, spec: str | None, out_dir: str = "profiles"):
        self.out_dir = out_dir
        self.active = False
        self.done = False
        self.path = None
        self._prof = None
        if not spec:
            self.start = self.stop = None
            self.done = True
            return
        try:
            a, b = spec.split(":")
            self.start, self.stop = int(a), int(b)
        except ValueError:
            raise ValueError(
                f"--profile expects 'start:stop' round numbers, got "
                f"{spec!r}") from None
        if self.stop <= self.start:
            raise ValueError(
                f"--profile window is empty: {self.start}:{self.stop}")

    def tick(self, rnd: int) -> None:
        """Advance to round ``rnd``: start capturing when the window opens,
        write the trace when it closes."""
        if self.done:
            return
        if not self.active and self.start <= rnd < self.stop:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self.active = True
        elif self.active and rnd >= self.stop:
            self._finish()

    def close(self) -> None:
        """Stop a still-open capture (end of run inside the window)."""
        if self.active:
            self._finish()

    def _finish(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        self.path = os.path.join(self.out_dir,
                                 f"trace_{self.start}_{self.stop}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self.active = False
        self.done = True
