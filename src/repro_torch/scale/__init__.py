"""Population scale-out (port of ``repro.scale``), opt-in through
:class:`repro_torch.configs.base.ScaleConfig`:

* :mod:`repro_torch.scale.slots` -- the O(m*d) uplink EF slot store, a
  ``[cap, d]`` residual pool with LRU slots and a mass-conserving eviction
  flush in place of the dense ``[n, d]`` ``FedState.e_up``
  (``ScaleConfig.ef_slots``);
* :mod:`repro_torch.scale.shard` -- client-axis sharding of
  population-sized state: identities and plain row gathers in one
  process, row moves between the ranks under a rank mesh;
* two-tier payload aggregation lives in
  :class:`repro_torch.comm.flat.FlatTransport` (``ScaleConfig.cohorts``).
"""
from repro_torch.scale import shard, slots
from repro_torch.scale.slots import SlotStore

__all__ = ["SlotStore", "shard", "slots"]
