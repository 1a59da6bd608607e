from . import mesh
from .mesh import (DataMesh, init_distributed, make_data_mesh, replicate,
                   shard_env_axis)
