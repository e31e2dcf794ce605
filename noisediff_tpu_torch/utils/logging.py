"""The training run's scalar log (`--use_tb_logger`).

The port's copy of noisediff_tpu/utils/logging.py's `ScalarLogger`: a JSONL
stream of {"tag", "value", "step", "t"} lines in `scalars.jsonl`, mirrored to
tensorboardX where that package imports.
"""
from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    """JSONL scalar stream with optional tensorboardX mirroring."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                   "t": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
