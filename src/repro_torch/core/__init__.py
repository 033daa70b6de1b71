"""Switching rules (port of ``repro.core``)."""
