"""Scalar logging to JSONL, mirrored to TensorBoard (counterpart of
avatarcap_tpu/utils/tb_logging.py). The JSONL record is the source of
truth; the TensorBoard event files are written when the ``tensorboard``
package is installed."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class ScalarLogger:
    """JSONL + TensorBoard scalar logger writing ``{name}_loss.jsonl`` and
    the event files of ``{name}_{timestamp}/`` into ``log_dir``."""

    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{name}_loss.jsonl")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:        # no tensorboard package: JSONL only
            return
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        self._tb = SummaryWriter(os.path.join(log_dir, f"{name}_{stamp}"))

    def log(self, scalars: Dict[str, float], step: int,
            extra: Optional[Dict] = None) -> None:
        rec = dict(extra or {})
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
