"""Logical-axis sharding (port of ``repro.sharding``): in one process the
activation and leading-axis constraints of :mod:`.partition` are
identities, as the reference's are without an active mesh; under a rank
mesh the client axis runs over the ranks of a ``torch.distributed`` group,
whose row movements go through :mod:`.collectives`."""
from repro_torch.sharding import collectives, partition

__all__ = ["collectives", "partition"]
