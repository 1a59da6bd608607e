"""``k1_roofline`` in the Humanoid cell: the generic reader
(``k1_roofline.py``), which takes the traced epoch's own model."""

import os

from benchmark.harness.spec import load_reader

read = load_reader(os.path.join(os.path.dirname(__file__), "k1_roofline.py"))
