"""``step_mfu`` in the Humanoid cell: the generic reader
(``step_mfu.py``), which takes the traced epoch's own model."""

import os

from benchmark.harness.spec import load_reader

read = load_reader(os.path.join(os.path.dirname(__file__), "step_mfu.py"))
