"""Console meters + offline experiment logging (a copy of
``ivit_tpu/utils/metrics.py``).

``AverageMeter``/``ProgressMeter`` mirror the reference trainer's console
meters (quant_train.py:700-739); ``JsonlLogger`` replaces W&B in the
zero-egress environment (per-iteration and per-epoch records to a .jsonl
file with the same field names the reference logs).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(1, self.count)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.batch_fmtstr = self._fmt(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int, log=logging.info):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        log("\t".join(entries))

    @staticmethod
    def _fmt(num_batches: int):
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"


class JsonlLogger:
    """Append-only metrics log; one JSON object per record."""

    def __init__(self, path: Optional[str], run_id: str = ""):
        self.path = path
        self.run_id = run_id
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, record: dict, step: Optional[int] = None):
        if self._fh is None:
            return
        rec = {"ts": time.time(), "run_id": self.run_id, **record}
        if step is not None:
            rec["step"] = step
        self._fh.write(json.dumps(rec, default=float) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
