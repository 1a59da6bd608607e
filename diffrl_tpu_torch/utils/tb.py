"""TensorBoard scalar logging (port of diffrl_tpu/utils/tb.py).

Tags follow the reference's ``name/iter``, ``name/step`` and ``name/time``
triplet so that the multi-seed averaging tool (examples/
combine_batch_logs.py) finds them. Without tensorboardX the writer is a
no-op, and so is a writer
given no directory.
"""

from __future__ import annotations

from typing import Optional


class TBWriter:
    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir is None:
            return
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except Exception:
            self._w = None

    def add_scalar(self, tag: str, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def log(self, name: str, value, iter_count: int, step_count: int,
            time_elapse: Optional[float] = None):
        """Log one metric under the reference's /iter /step /time triplet."""
        self.add_scalar(f"{name}/iter", value, iter_count)
        self.add_scalar(f"{name}/step", value, step_count)
        if time_elapse is not None:
            self.add_scalar(f"{name}/time", value, time_elapse)

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
