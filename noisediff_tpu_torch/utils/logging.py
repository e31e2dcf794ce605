"""The run's log and its scalar log (`--use_tb_logger`).

The port's copy of noisediff_tpu/utils/logging.py: `setup_logger` sends the
root logger's records to a log file and to stdout in the reference's format
(utils/util.py:62-80), `print_args` logs every argument, and `ScalarLogger`
writes a JSONL stream of {"tag", "value", "step", "t"} lines in
`scalars.jsonl`, mirrored to tensorboardX where that package imports.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

LOG_FORMAT = "%(asctime)s [%(levelname)-5.5s]  %(message)s"
# the name of the handlers setup_logger adds, so that a second call in one
# process replaces them instead of doubling every record
_RUN_LOG = "noisediff_tpu_torch.run_log"


def setup_logger(log_file_path: str) -> None:
    """Root logger at INFO into log_file_path and stdout, replacing the
    handlers an earlier call added; first logs "Logging file is <path>"."""
    root = logging.getLogger()
    for h in [h for h in root.handlers if h.name == _RUN_LOG]:
        root.removeHandler(h)
        h.close()
    root.setLevel(logging.INFO)
    os.makedirs(os.path.dirname(log_file_path) or ".", exist_ok=True)
    fmt = logging.Formatter(LOG_FORMAT)
    for handler in (logging.FileHandler(log_file_path, encoding="utf-8"),
                    logging.StreamHandler(sys.stdout)):
        handler.name = _RUN_LOG
        handler.setFormatter(fmt)
        root.addHandler(handler)
    logging.info("Logging file is %s", log_file_path)


def print_args(args) -> None:
    for arg in vars(args):
        logging.info("%s:%s", arg, getattr(args, arg))


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
