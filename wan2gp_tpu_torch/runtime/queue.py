"""Generation task queue (the parts of wan2gp_tpu/runtime/queue.py that the
port's CLI and API use): ordered tasks of settings dicts, thread-safe for a
submitter/worker split, loaded from a queue .json for `--process`.

Not ported yet: queue.zip with media attachments, saving, autosave and
task editing (they serve the web UI, not ported yet).
"""
from __future__ import annotations

import itertools
import json
import threading
from typing import Any, Dict, List, Optional


class Task:
    def __init__(self, settings: Dict[str, Any], task_id: int):
        self.id = task_id
        self.settings = dict(settings)
        self.status = "queued"      # queued | running | done | error
        self.error: Optional[str] = None
        self.outputs: List[str] = []


class TaskQueue:
    def __init__(self):
        self._lock = threading.RLock()
        self._tasks: List[Task] = []
        self._counter = itertools.count(1)

    def add(self, settings: Dict[str, Any], priority: bool = False) -> Task:
        with self._lock:
            task = Task(settings, next(self._counter))
            if priority:
                # insert after any running task (reference inline priority)
                idx = next((i + 1 for i, t in enumerate(self._tasks)
                            if t.status == "running"), 0)
                self._tasks.insert(idx, task)
            else:
                self._tasks.append(task)
            return task

    def next_pending(self) -> Optional[Task]:
        with self._lock:
            return next((t for t in self._tasks if t.status == "queued"),
                        None)

    def tasks(self) -> List[Task]:
        with self._lock:
            return list(self._tasks)

    def pending_count(self) -> int:
        with self._lock:
            return sum(t.status == "queued" for t in self._tasks)

    def load(self, path: str):
        """Queue a .json file: {"tasks": [...]}, a list, or one bare
        settings dict.  Entries are {"settings": ...}, the reference
        manifest's {"id", "params"}, or bare settings dicts."""
        if path.endswith(".zip"):
            raise NotImplementedError(
                "queue.zip is not ported yet (ROADMAP Queue 1: runtime)")
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data["tasks"] if "tasks" in data else [data]
        for entry in data:
            settings = entry.get("settings", entry.get("params", entry))
            self.add(settings)
