"""Asset importers (port of diffrl_tpu/sim/importers): MJCF, URDF (its mesh
colliders through the OBJ/STL reader) and SNU, and the procedural capsule
chain."""

from .mjcf import parse_mjcf
from .procedural import build_tree
from .snu import Skeleton, SnuGains, load_snu
from .urdf import urdf_load
