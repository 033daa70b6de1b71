"""Task adapters (port of ``repro.tasks``)."""
