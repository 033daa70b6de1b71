"""The federated client population (port of ``repro.fleet``): who takes
part and what data they hold.

* ``partitions`` -- non-IID partitioners (iid / dirichlet label skew /
  zipf quantity skew / feature shift) producing padded shards with
  per-client counts,
* ``samplers``   -- client-participation laws (uniform / weighted with
  Horvitz-Thompson reweighting / Markov availability / fixed replay) and
  their mid-round arrival/departure events (async rounds),
* ``provision``  -- the :class:`Fleet` and the per-round minibatch
  provisioning, the same rows in mask and gather mode.
"""
from repro_torch.fleet.partitions import (ClientPartition, Partitioner,
                                          get_partitioner, partitioner_names,
                                          register_partitioner)
from repro_torch.fleet.provision import (Fleet, ProvisionKey, build_fleet,
                                         data_weights, from_stacked,
                                         minibatch, round_key)
from repro_torch.fleet.samplers import (ClientSampler, Events, get_sampler,
                                        register_sampler, sampler_names)

__all__ = [
    "ClientPartition", "ClientSampler", "Events", "Fleet", "Partitioner",
    "ProvisionKey", "build_fleet", "data_weights", "from_stacked",
    "get_partitioner", "get_sampler", "minibatch", "partitioner_names",
    "register_partitioner", "register_sampler", "round_key", "sampler_names",
]
