"""The (data × model) mesh: its ranks (mesh.py), its sharding rules (sharding.py) and its
collectives (collectives.py). Counterpart of adversarialvlm_tpu/parallel."""

from adversarialvlm_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    batch_rows,
    dp_size,
    launch,
    make_mesh,
    mesh_shape,
    use_mesh,
)
from adversarialvlm_tpu_torch.parallel.sharding import (
    shard_params,
    text_param_shardings,
    vlm_param_shardings,
)

__all__ = [
    "Mesh",
    "active_mesh",
    "batch_rows",
    "dp_size",
    "launch",
    "make_mesh",
    "mesh_shape",
    "shard_params",
    "text_param_shardings",
    "use_mesh",
    "vlm_param_shardings",
]
