"""Asset importers (port of diffrl_tpu/sim/importers: MJCF, URDF and SNU;
the mesh reader that URDF mesh colliders will use)."""

from .mjcf import parse_mjcf
from .snu import Skeleton, SnuGains, load_snu
from .urdf import urdf_load
