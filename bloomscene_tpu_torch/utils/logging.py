"""Run logging: a JSONL event stream and an in-memory history.

The port of ``bloomscene_tpu/utils/logging.py``: local first, with an
optional wandb mirror when the package is importable and a run is asked
for. Nothing touches the network by default.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class RunLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 use_wandb: bool = False, project: str = "bloomscene_tpu",
                 config: Optional[dict] = None):
        self.history: list[dict] = []
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "events.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, config=config)
            except Exception:   # no wandb, or no run it could open
                self._wandb = None

    def log(self, record: dict, step: Optional[int] = None):
        rec = dict(record)
        rec.setdefault("_time", time.time())
        if step is not None:
            rec.setdefault("step", step)
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
