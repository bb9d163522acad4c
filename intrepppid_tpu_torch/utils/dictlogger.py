"""In-memory metrics logger (`intrepppid_tpu/utils/dictlogger.py`, a copy;
`intrepppid/utils/dictlogger.py:23-72` in the reference).

Accumulates every logged metric into ``defaultdict(list)``; dumped to
``metrics.json`` after testing (`intrepppid/e2e/e2e_triplet.py:428-431`).
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional


class DictLogger:
    def __init__(self):
        self.metrics = defaultdict(list)
        self.hyperparams: Optional[dict] = None

    def log_hyperparams(self, params: dict) -> None:
        self.hyperparams = dict(params)

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        for k, v in metrics.items():
            entry = {"value": float(v)}
            if step is not None:
                entry["step"] = int(step)
            self.metrics[k].append(entry)

    def save_json(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.metrics, f, indent=3, default=float)
