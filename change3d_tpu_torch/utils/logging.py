"""Experiment logging (counterpart of ``change3d_tpu/utils/logging.py``):
a tab-separated text log that people tail and a JSONL stream for tools,
``{save_dir}/{name}.txt`` and ``{save_dir}/{name}.jsonl``."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from change3d_tpu_torch.parallel import distributed


class MetricLogger:
    def __init__(self, save_dir: str, name: str = "train_val_log"):
        os.makedirs(save_dir, exist_ok=True)
        self.text_path = os.path.join(save_dir, f"{name}.txt")
        self.jsonl_path = os.path.join(save_dir, f"{name}.jsonl")
        self._text = open(self.text_path, "a+")
        self._jsonl = open(self.jsonl_path, "a+")

    def log_config(self, config: Dict[str, Any]):
        self._text.write("Model Configurations:\n")
        for k, v in config.items():
            self._text.write(f"{k}: {v}\n")
        self._text.write("\n" + "-" * 60 + "\n")
        self._jsonl.write(json.dumps({"event": "config", **_jsonable(config)}) + "\n")
        self.flush()

    def log_epoch(self, epoch: int, metrics: Dict[str, Any], split: str = "val"):
        row = "\t".join([str(epoch)] + [f"{v:.4f}" if isinstance(v, float) else str(v)
                                        for v in metrics.values()])
        self._text.write(row + "\n")
        self._jsonl.write(json.dumps({"event": "epoch", "epoch": epoch, "split": split,
                                      "time": time.time(), **_jsonable(metrics)}) + "\n")
        self.flush()

    def flush(self):
        self._text.flush()
        self._jsonl.flush()

    def close(self):
        self._text.close()
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


class NullLogger:
    """No-op logger for the processes of a multi-GPU run other than the
    first (they share one save_dir)."""

    def log_config(self, config):
        pass

    def log_epoch(self, epoch, metrics, split="val"):
        pass

    def flush(self):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


def setup_logger(save_dir: str, config: Optional[Dict[str, Any]] = None,
                 name: str = "train_val_log"):
    """A MetricLogger that has logged ``config``, or a NullLogger on every
    process of a group but process 0. Every process waits until process 0
    has made ``save_dir`` and written the config."""
    primary = distributed.is_primary()
    logger = MetricLogger(save_dir, name) if primary else NullLogger()
    if primary and config:
        logger.log_config(config)
    distributed.barrier()
    return logger
