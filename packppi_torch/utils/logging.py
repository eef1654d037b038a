"""Logging and scalar metrics: a console logger, and ``MetricLogger`` with a
JSONL record that is always on and TensorBoard when it can be imported."""
from __future__ import annotations

import json
import logging
from pathlib import Path


def get_logger(name: str = "packppi") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricLogger:
    """Scalar metrics: ``metrics.jsonl`` always; TensorBoard when
    ``"tensorboard"`` is among ``backends`` and ``torch.utils.tensorboard``
    imports (a machine without the ``tensorboard`` package logs that and
    carries on with the JSONL record). Other backends are named in the log
    and not written."""

    def __init__(self, log_dir: str, backends=("tensorboard",)):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self.tb = None
        log = get_logger(__name__)
        for backend in tuple(backends or ()):
            if backend != "tensorboard":
                log.info(f"metric backend {backend!r} is not available here; "
                         "metrics.jsonl holds the record")
                continue
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(str(self.log_dir / "tb"))
            except Exception as e:  # noqa: BLE001 (ImportError, or a broken install)
                log.info(f"TensorBoard is not available ({type(e).__name__}: {e}); "
                         "metrics.jsonl holds the record")

    def log(self, step: int, metrics: dict, prefix: str = "") -> None:
        record = {"step": int(step)}
        for k, v in metrics.items():
            name = f"{prefix}{k}"
            v = float(v)
            record[name] = v
            if self.tb:
                self.tb.add_scalar(name, v, step)
        self.jsonl.write(json.dumps(record) + "\n")
        self.jsonl.flush()

    def close(self):
        if self.tb:
            self.tb.close()
        self.jsonl.close()
