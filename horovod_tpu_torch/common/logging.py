"""Leveled, rank-prefixed logging.

Port of the JAX package's ``common/logging.py``, the equivalent of the
reference's C++ logging (horovod/common/logging.cc:1-190):
glog-style levels selected by ``HOROVOD_LOG_LEVEL`` (trace/debug/info/warning/error/
fatal) and timestamp hiding via ``HOROVOD_LOG_HIDE_TIME``.
"""

import logging
import os
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_logger = None


def _rank_prefix():
    # Late import to avoid cycles; shows [rank] like LogMessage in logging.cc.
    try:
        from horovod_tpu_torch.common import basics
        if basics.is_initialized():
            return f"[{basics.rank()}]"
    except Exception:
        pass
    return "[-]"


class _RankFilter(logging.Filter):
    def filter(self, record):
        record.hvd_rank = _rank_prefix()
        return True


def get_logger():
    global _logger
    if _logger is None:
        _logger = logging.getLogger("horovod_tpu_torch")
        from horovod_tpu_torch.common.config import Config, _env_bool
        level = _LEVELS.get(
            os.environ.get("HOROVOD_LOG_LEVEL", Config.log_level).lower(),
            logging.WARNING)
        _logger.setLevel(level)
        handler = logging.StreamHandler(sys.stderr)
        hide_time = _env_bool("HOROVOD_LOG_HIDE_TIME", Config.log_hide_time)
        fmt = "%(hvd_rank)s %(levelname)s %(message)s" if hide_time else \
            "%(asctime)s %(hvd_rank)s %(levelname)s %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        handler.addFilter(_RankFilter())
        _logger.addHandler(handler)
        _logger.propagate = False
    return _logger


def log(level, msg, *args):
    get_logger().log(_LEVELS.get(level, logging.INFO), msg, *args)


def trace(msg, *args):
    get_logger().log(TRACE, msg, *args)


def debug(msg, *args):
    get_logger().debug(msg, *args)


def info(msg, *args):
    get_logger().info(msg, *args)


def warning(msg, *args):
    get_logger().warning(msg, *args)


def error(msg, *args):
    get_logger().error(msg, *args)
