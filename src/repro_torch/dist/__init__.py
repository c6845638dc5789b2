"""Distribution layer: logical-axis → mesh-axis sharding resolution on
``torch.distributed`` device meshes (DTensor)."""
from .sharding import (DEFAULT_RULES, AbstractMesh, NamedSharding,
                       distribute_params, param_shardings, placements_for,
                       resolve_spec, seq_shard_active, shard_act,
                       sharding_ctx, spec_for)
