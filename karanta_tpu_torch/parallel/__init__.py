"""Multi-rank serving and training over ``torch.distributed`` (port of
``karanta_tpu/parallel/``): the mesh (``mesh.py``), the logical-axis
sharding rules with the model's collectives (``sharding.py``), spawned
ranks (``launch.py``), sequence parallelism (``context.py``) and the GPipe
schedule (``pipeline.py``)."""

from karanta_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshConfig, create_mesh, initialize_distributed)
from karanta_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES, LogicalAxisRules, shard_params, spec_from_logical)
