"""Indent-scoped search tracing.

Rebuild of the reference's RecursiveLogger (include/flexflow/utils/
recursive_logger.h, src/runtime/recursive_logger.cc) used throughout the
substitution search: nested scopes indent their messages so the search tree
is readable in the log.
"""
from __future__ import annotations

import contextlib
import logging


class RecursiveLogger:
    def __init__(self, name: str):
        self.logger = logging.getLogger(f"flexflow_tpu.{name}")
        self.depth = 0

    @contextlib.contextmanager
    def scope(self, msg: str = "", *args):
        if msg:
            self.info(msg, *args)
        self.depth += 1
        try:
            yield self
        finally:
            self.depth -= 1

    def _emit(self, level: int, msg: str, *args) -> None:
        self.logger.log(level, "%s" + msg, "  " * self.depth, *args)

    def info(self, msg: str, *args) -> None:
        self._emit(logging.INFO, msg, *args)

    def debug(self, msg: str, *args) -> None:
        self._emit(logging.DEBUG, msg, *args)

    def spew(self, msg: str, *args) -> None:
        self._emit(logging.DEBUG, msg, *args)
