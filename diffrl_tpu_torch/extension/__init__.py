"""Omniverse Kit extension for the port (port of diffrl_tpu/extension).

An editor panel that loads an experiment script, drives training or
inference one tick per viewport update, streams the loss curve and log
into the UI, and keeps the USD stage timeline in sync with simulated time.
The runtime-independent driver (:mod:`.experiment`) is a small protocol
object made by the script's ``make_experiment()`` factory, importable and
testable headlessly (tests/test_torch_extension.py); only :mod:`.kit_ext`
touches ``omni.*``, and only inside ``on_startup``.
"""

from .experiment import (  # noqa: F401
    Experiment,
    PolicyExperiment,
    load_experiment_script,
)

__all__ = ["Experiment", "PolicyExperiment", "load_experiment_script",
           "is_kit_available"]


def is_kit_available() -> bool:
    """True when running inside an Omniverse Kit process (omni.ui import)."""
    try:  # pragma: no cover - requires an Omniverse runtime
        import omni.ui  # noqa: F401

        return True
    except Exception:
        return False
