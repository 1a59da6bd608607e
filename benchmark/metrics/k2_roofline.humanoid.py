"""``k2_roofline`` in the Humanoid cell: the generic reader
(``k2_roofline.py``), which takes the traced epoch's own model."""

import os

from benchmark.harness.spec import load_reader

read = load_reader(os.path.join(os.path.dirname(__file__), "k2_roofline.py"))
