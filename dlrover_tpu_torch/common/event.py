"""Structured training events: duration spans for goodput accounting.

The port's trim of ``dlrover_tpu/common/event.py`` to what a worker emits:
:class:`TrainEvent` names and ``get_emitter(target).span(...)``. Records
are the reference's, one JSON object per line ``{"ts", "target", "name",
"phase", "event_id", "content"}`` with phase BEGIN, END or INSTANT, so the
JAX package's offline goodput analysis (``compute_goodput``) reads a port
worker's event file as it reads its own.
"""

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, TextIO

from dlrover_tpu_torch.common.constants import ConfigKey, env_str
from dlrover_tpu_torch.common.log import logger


class EventPhase:
    BEGIN = "BEGIN"
    END = "END"
    INSTANT = "INSTANT"


class TrainEvent:
    STEP = "train#step"
    TRAINING = "train#training"  # the productive span goodput counts
    CKPT_SAVE = "train#ckpt_save"
    CKPT_RESTORE = "train#ckpt_restore"


class LogExporter:
    def export(self, record: Dict[str, Any]) -> None:
        logger.info("event %s", json.dumps(record, sort_keys=True))


class FileExporter:
    """Append-only JSONL."""

    def __init__(self, path: str):
        self._path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._fh: Optional[TextIO] = None

    def export(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._fh is None:
                self._fh = open(self._path, "a", buffering=1)
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")


class DurationSpan:
    """begin()/end() pair or context manager."""

    def __init__(self, emitter: "EventEmitter", name: str, content: Dict):
        self._emitter = emitter
        self.name = name
        self.content = content
        self.event_id = next(emitter._ids)
        self._begin_ts: Optional[float] = None

    def begin(self) -> "DurationSpan":
        self._begin_ts = time.monotonic()
        self._emitter._emit(self.name, EventPhase.BEGIN, self.event_id,
                            self.content)
        return self

    def end(self, **extra) -> float:
        """Returns the span's duration in seconds."""
        now = time.monotonic()
        duration = now - (self._begin_ts or now)
        self._emitter._emit(self.name, EventPhase.END, self.event_id,
                            {**self.content, **extra, "duration_s": duration})
        return duration

    def __enter__(self) -> "DurationSpan":
        return self.begin()

    def __exit__(self, exc_type, *_):
        self.end(ok=exc_type is None)


class EventEmitter:
    def __init__(self, target: str = "", exporters: Optional[List] = None):
        self.target = target
        self._exporters = exporters if exporters is not None else [
            LogExporter()]
        self._ids = itertools.count(1)

    def span(self, name: str, **content) -> DurationSpan:
        return DurationSpan(self, name, content)

    def _emit(self, name: str, phase: str, event_id: int,
              content: Dict) -> None:
        record = {"ts": time.time(), "target": self.target, "name": name,
                  "phase": phase, "event_id": event_id, "content": content}
        for exporter in self._exporters:
            try:
                exporter.export(record)
            except Exception:  # noqa: BLE001 — telemetry must not kill work
                logger.exception("event export failed")


_emitters: Dict[str, EventEmitter] = {}
_lock = threading.Lock()


def get_emitter(target: str = "") -> EventEmitter:
    """Per-target process-wide emitter; also writes JSONL under
    ``DLROVER_TPU_EVENT_DIR`` when it is set."""
    with _lock:
        if target not in _emitters:
            exporters: List = [LogExporter()]
            event_dir = env_str(ConfigKey.EVENT_DIR, "")
            if event_dir:
                exporters.append(FileExporter(os.path.join(
                    event_dir, f"events_{target or os.getpid()}.jsonl")))
            _emitters[target] = EventEmitter(target, exporters)
        return _emitters[target]
