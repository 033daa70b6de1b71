"""Client samplers (port of ``repro.fleet``)."""
