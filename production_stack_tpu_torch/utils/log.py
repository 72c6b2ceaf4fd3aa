"""Colored logging (parity with reference src/vllm_router/log.py)."""

import logging
import os
import sys

_RESET = "\x1b[0m"
_COLORS = {
    logging.DEBUG: "\x1b[38;20m",  # grey
    logging.INFO: "\x1b[32;20m",  # green
    logging.WARNING: "\x1b[33;20m",  # yellow
    logging.ERROR: "\x1b[31;20m",  # red
    logging.CRITICAL: "\x1b[31;1m",  # bold red
}
_FMT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"


class ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool = True):
        super().__init__(_FMT)
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


def init_logger(name: str, level: str | int | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(ColorFormatter(use_color=sys.stderr.isatty()))
        logger.addHandler(handler)
        logger.propagate = False
    env_level = os.environ.get("PSTPU_LOG_LEVEL")
    logger.setLevel(level or env_level or logging.INFO)
    return logger
