"""Asset importers (port of diffrl_tpu/sim/importers: MJCF only so far)."""

from .mjcf import parse_mjcf
