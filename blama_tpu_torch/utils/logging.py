"""Structured logging: the jalog scope + engine-log-bridge analog.

Reference: jalog scope "bl:llama" with the LLAMA_LOG macro
(reference llama/Logging.{hpp,cpp}) and the GGML→jalog
level-mapping bridge installed at init (Init.cpp:11-31). Here the "engine" is
PyTorch: `bridge_engine_logs()` routes torch's loggers under the
blama_tpu_torch namespace so one config controls everything, mirroring
llama_log_set.
"""

from __future__ import annotations

import logging

SCOPE = "blama_tpu_torch"

Debug = logging.DEBUG
Info = logging.INFO
Warning_ = logging.WARNING
Error = logging.ERROR


def scope_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{SCOPE}.{name}" if name else SCOPE)


def log(level: int, *args) -> None:
    """LLAMA_LOG-style variadic logging (Logging.hpp:12)."""
    scope_logger().log(level, "%s", "".join(str(a) for a in args))


class _Redirect(logging.Handler):
    def __init__(self, target: logging.Logger):
        super().__init__()
        self._target = target

    def emit(self, record: logging.LogRecord) -> None:
        # strip trailing newlines like the reference bridge (Init.cpp:24-28)
        msg = record.getMessage().rstrip("\n")
        if msg:
            self._target.log(record.levelno, "%s", msg)


def bridge_engine_logs() -> None:
    """Route torch logs under the blama_tpu_torch scope (llama_log_set analog)."""
    target = scope_logger("engine")
    for name in ("torch",):
        lg = logging.getLogger(name)
        if not any(isinstance(h, _Redirect) for h in lg.handlers):
            lg.addHandler(_Redirect(target))


def setup(level: int = logging.INFO, stream=None) -> None:
    """Convenience one-call config (async-sink analog of HttpServerMain.cpp:374
    is Python logging's QueueHandler; sync default here)."""
    handler = logging.StreamHandler(stream)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s [%(name)s] %(message)s")
    )
    root = scope_logger()
    root.setLevel(level)
    root.addHandler(handler)
    bridge_engine_logs()
