"""Flat-buffer optimizer arithmetic (port of ``repro.optim``)."""
