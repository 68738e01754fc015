"""Counterpart of ``src/repro/distributed/``: the spec rules
(``sharding.py``) and the activation / shard contexts with the model's
collectives (``context.py``).  The reference's ``named`` (specs to
``NamedSharding``s) is :func:`~.sharding.local_shard` here (each leaf cut to
this process's slice)."""
from .context import activation_spec, constrain, sequence_parallel_spec
from .sharding import (P, ShardingPlan, batch_specs, cache_specs, data_axes,
                       local_shard, param_specs, zero1_specs)

__all__ = ["P", "ShardingPlan", "batch_specs", "cache_specs", "data_axes",
           "local_shard", "param_specs", "zero1_specs", "activation_spec",
           "constrain", "sequence_parallel_spec"]
