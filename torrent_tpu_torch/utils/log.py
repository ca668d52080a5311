"""Structured per-subsystem loggers.

The reference has no observability beyond stray console.logs and ~20
`// TODO log` sites (SURVEY §5); here every subsystem logs under the
``torrent_tpu_torch.*`` hierarchy so applications can filter per layer.

``TORRENT_TPU_LOG`` sets the level (an invalid value falls back to
WARNING — with a one-time warning, never silently).
``TORRENT_TPU_LOG_JSON=1`` switches the handler to structured JSON
lines (``ts``, ``level``, ``subsystem``, ``msg``), the format log
shippers ingest without a parse rule, plus the ``trace_id`` of the
span tracer's current context (``obs/tracer.py``) when there is one.
"""

from __future__ import annotations

import json
import logging
import os

_ROOT = "torrent_tpu_torch"
_configured = False


class _JsonFormatter(logging.Formatter):
    """One JSON object per line, keys sorted for stable diffs."""

    def format(self, record: logging.LogRecord) -> str:
        name = record.name
        subsystem = (
            name[len(_ROOT) + 1 :] if name.startswith(_ROOT + ".") else name
        )
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "subsystem": subsystem,
            "msg": record.getMessage(),
        }
        try:  # lazy: log is imported far below obs in the module graph
            from torrent_tpu_torch.obs.tracer import tracer

            ctx = tracer().current_context()
            if ctx is not None:
                out["trace_id"] = ctx[0]
        except Exception:
            pass
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, sort_keys=True)


def _json_mode() -> bool:
    return os.environ.get("TORRENT_TPU_LOG_JSON", "") in ("1", "true")


def get_logger(subsystem: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("TORRENT_TPU_LOG", "WARNING").upper()
        logger = logging.getLogger(_ROOT)
        if not logger.handlers:
            handler = logging.StreamHandler()
            if _json_mode():
                handler.setFormatter(_JsonFormatter())
            else:
                handler.setFormatter(
                    logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
                )
            logger.addHandler(handler)
        if level in logging._nameToLevel:
            logger.setLevel(level)
        else:
            # fall back loudly, once: a typo'd TORRENT_TPU_LOG=DEUBG
            # must not silently swallow the INFO logs it asked for
            logger.setLevel("WARNING")
            logger.warning(
                "invalid TORRENT_TPU_LOG level %r; using WARNING", level
            )
        _configured = True
    return logging.getLogger(f"{_ROOT}.{subsystem}")
