"""Logical-axis sharding rules of the port (``rules.py``)."""
from .rules import (DEFAULT_RULES, NamedSharding, PartitionSpec,
                    batch_axes_for, constrain, current_mesh,
                    decode_cache_rules, named_sharding, param_partition_specs,
                    sharding_ctx, spec_for)

__all__ = ["DEFAULT_RULES", "PartitionSpec", "spec_for",
           "param_partition_specs", "constrain", "sharding_ctx",
           "current_mesh", "batch_axes_for", "decode_cache_rules",
           "NamedSharding", "named_sharding"]
