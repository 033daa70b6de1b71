"""The federation round engine (port of ``repro.engine``)."""
