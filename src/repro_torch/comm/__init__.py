"""Wire transports and flat codecs (port of ``repro.comm``)."""
