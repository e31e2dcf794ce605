"""The run log of the port's CLIs against the JAX package's.

Both packages' `setup_run_dirs` on the same arguments must print the same
lines to stdout, timestamps aside (the record's asctime and the log file's
name), and write the same lines to the log file; a second call in one
process must not double the port's records (the learning gate runs four
CLIs in one process). Every handler a call adds is removed afterwards:
tier-1 runs test files in xdist workers that share a process.
"""
import argparse
import contextlib
import glob
import io
import logging
import os
import re

from noisediff_tpu.cli import common as jax_common
from noisediff_tpu_torch.cli import common as port_common

_STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} ")
_FILE_STAMP = re.compile(r"\d{8}_\d{6}\.log")


def _args(save_folder, rank=-1):
    return argparse.Namespace(name="run", save_folder=str(save_folder), lr=2e-4,
                              net_name="NoiseDiffNet", rank=rank)


@contextlib.contextmanager
def _root_handlers_restored():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield root
    finally:
        for h in [h for h in root.handlers if h not in handlers]:
            root.removeHandler(h)
            h.close()
        root.setLevel(level)


def _strip(text, save_folder):
    lines = []
    for line in text.splitlines():
        line = _FILE_STAMP.sub("<stamp>.log", _STAMP.sub("", line))
        lines.append(line.replace(str(save_folder), "<dir>"))
    return lines


def _run(module, save_folder, calls=1, rank=-1):
    out = io.StringIO()
    with _root_handlers_restored(), contextlib.redirect_stdout(out):
        for _ in range(calls):
            module.setup_run_dirs(_args(save_folder, rank))
    logs = sorted(glob.glob(os.path.join(save_folder, "run", "*.log")))
    return out.getvalue(), logs


def test_port_run_log_prints_what_the_jax_one_prints(tmp_path):
    jax_out, jax_logs = _run(jax_common, tmp_path / "jax")
    port_out, port_logs = _run(port_common, tmp_path / "port")
    jax_lines = _strip(jax_out, tmp_path / "jax")
    port_lines = _strip(port_out, tmp_path / "port")
    assert port_lines == jax_lines
    assert port_lines[0] == "[INFO ]  Logging file is <dir>/run/<stamp>.log"
    assert "[INFO ]  net_name:NoiseDiffNet" in port_lines
    # the log file receives the same lines
    assert len(jax_logs) == len(port_logs) == 1
    with open(port_logs[0]) as f:
        assert _strip(f.read(), tmp_path / "port") == port_lines
    with open(jax_logs[0]) as f:
        assert _strip(f.read(), tmp_path / "jax") == jax_lines


def test_port_run_log_second_call_replaces_its_handlers(tmp_path):
    once, _ = _run(port_common, tmp_path / "a")
    twice, _ = _run(port_common, tmp_path / "b", calls=2)
    once_lines = _strip(once, tmp_path / "a")
    assert _strip(twice, tmp_path / "b") == once_lines + once_lines
    with _root_handlers_restored() as root:
        port_common.setup_run_dirs(_args(tmp_path / "c"))
        port_common.setup_run_dirs(_args(tmp_path / "c"))
        ours = [h for h in root.handlers if h.name == "noisediff_tpu_torch.run_log"]
        assert sorted(type(h).__name__ for h in ours) == ["FileHandler", "StreamHandler"]


def test_port_run_log_rank_above_zero_prints_nothing(tmp_path):
    out, logs = _run(port_common, tmp_path / "r1", rank=1)
    assert out == "" and logs == []
    assert not os.path.exists(tmp_path / "r1" / "run")
