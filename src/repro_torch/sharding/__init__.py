"""Logical-axis sharding (port of ``repro.sharding``): in one process the
activation, leading-axis and flat-axis constraints of :mod:`.partition`
are identities, as the reference's are without an active mesh; under a
rank mesh the client axis and the model axis of the flat state run over
``torch.distributed`` groups, whose row and column movements go through
:mod:`.collectives`."""
from repro_torch.sharding import collectives, partition

__all__ = ["collectives", "partition"]
