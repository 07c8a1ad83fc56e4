"""Logging utilities (port of `video_llava_seg_tpu/utils.py`, the
reference's `llava/utils.py`).

- `build_logger`: a daily rotating file log under LOGDIR (the
  VIDEONET_LOG_DIR environment variable, `logs` by default) on every
  logger, and optionally stdout / stderr captured into loggers;
- `StreamToLogger`: the file-like object that does the capturing.

The JAX package's `tree_to` (a recursive device / dtype move over a tree
of jax or numpy arrays) has no copy here: the port moves and casts its
trees with `bridge.cast_tree` (tensors: device, and dtype except the
quantized trees' fp32 scales) and `bridge.from_jax` (numpy or jax arrays
into tensors).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
from typing import Optional

LOGDIR = os.environ.get("VIDEONET_LOG_DIR", "logs")

_handler: Optional[logging.Handler] = None


class StreamToLogger:
    """File-like object that redirects writes to a logger, a line at a
    time; a partial line waits for its newline or `flush`."""

    def __init__(self, logger: logging.Logger, log_level=logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp_linebuf = self.linebuf + buf
        self.linebuf = ""
        for line in temp_linebuf.splitlines(True):
            if line[-1] == "\n":
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf != "":
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def build_logger(logger_name: str, logger_filename: str,
                 redirect_streams: bool = True) -> logging.Logger:
    """The logger `logger_name` at INFO. The first call adds one daily
    rotating file handler (UTC, LOGDIR/logger_filename) to every logger
    that exists then; redirect_streams replaces sys.stdout / sys.stderr
    by `StreamToLogger`s of the "stdout" (INFO) and "stderr" (ERROR)
    loggers."""
    global _handler
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    if redirect_streams:
        stdout_logger = logging.getLogger("stdout")
        stdout_logger.setLevel(logging.INFO)
        sys.stdout = StreamToLogger(stdout_logger, logging.INFO)
        stderr_logger = logging.getLogger("stderr")
        stderr_logger.setLevel(logging.ERROR)
        sys.stderr = StreamToLogger(stderr_logger, logging.ERROR)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if _handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        _handler = logging.handlers.TimedRotatingFileHandler(
            os.path.join(LOGDIR, logger_filename), when="D", utc=True,
            encoding="UTF-8")
        _handler.setFormatter(formatter)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)
    return logger
