"""In-process API: Session with task submission and typed events.

Copy of wan2gp_tpu/runtime/api.py over the port's GenerationService:
init() -> Session; submit_task(settings); ProgressUpdate / GenerationResult
events.  The service runs on `cuda` unless
`device="cpu"` is passed through the keyword arguments.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
from typing import Any, Dict, Iterator, List, Optional

from .queue import TaskQueue
from .service import GenerationService


@dataclasses.dataclass
class ProgressUpdate:
    task_id: int
    step: int = -1
    total_steps: int = -1
    status: str = ""


@dataclasses.dataclass
class GenerationResult:
    task_id: int
    outputs: List[str] = dataclasses.field(default_factory=list)
    error: Optional[str] = None

    @property
    def ok(self):
        return self.error is None


class Session:
    """submit settings dicts, consume events, fetch outputs."""

    def __init__(self, service: Optional[GenerationService] = None,
                 **service_kwargs):
        self.service = service or GenerationService(**service_kwargs)
        self.queue = TaskQueue()
        self._events: _queue.Queue = _queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- submission ---------------------------------------------------------

    def submit_task(self, settings: Dict[str, Any],
                    priority: bool = False) -> int:
        task = self.queue.add(settings, priority=priority)
        self._ensure_worker()
        return task.id

    # -- events -------------------------------------------------------------

    def events(self, timeout: Optional[float] = None) -> Iterator[Any]:
        """Yield events until the queue drains."""
        while True:
            try:
                ev = self._events.get(timeout=timeout)
            except _queue.Empty:
                return
            yield ev
            if (isinstance(ev, GenerationResult)
                    and self.queue.pending_count() == 0):
                worker = self._worker
                if worker is None or not worker.is_alive() \
                        or self.queue.next_pending() is None:
                    return

    def wait(self) -> List[GenerationResult]:
        results = []
        for ev in self.events():
            if isinstance(ev, GenerationResult):
                results.append(ev)
        return results

    # -- worker ---------------------------------------------------------

    def _ensure_worker(self):
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _run(self):
        def on_event(kind, data):
            if kind == "task_start":
                self._events.put(ProgressUpdate(data.id, status="started"))
            elif kind == "status":
                self._events.put(ProgressUpdate(-1, status=str(data)))
            elif kind == "task_done":
                self._events.put(GenerationResult(data.id,
                                                  outputs=data.outputs))
            elif kind == "task_error":
                self._events.put(GenerationResult(data.id, error=data.error))

        self.service.process_queue(self.queue, on_event=on_event)


def init(**service_kwargs) -> Session:
    """Entry point: a Session over a new GenerationService(**service_kwargs)."""
    return Session(**service_kwargs)
