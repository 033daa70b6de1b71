"""Logical-axis sharding (port of ``repro.sharding``): on one card the
activation and leading-axis constraints of :mod:`.partition` are
identities, as the reference's are without an active mesh."""
from repro_torch.sharding import partition

__all__ = ["partition"]
