"""Text + scalar logging (counterpart of `r3dfsseg_tpu/utils/logger.py`).

`IOStream` tees to stdout and an append-only per-phase logfile; `init_logger`
dumps sorted config.  Scalar series go to a lightweight JSONL metrics file
(`scalars.jsonl`, readable anywhere) and, where `torch.utils.tensorboard`
imports, to TensorBoard, as the original code's SummaryWriter
(`mpti_train_noise.py:108-134`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional


class IOStream:
    def __init__(self, path: str):
        self.f = open(path, "a")

    def cprint(self, text: str):
        print(text)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


class ScalarWriter:
    """JSONL scalar log with optional TensorBoard mirroring."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:       # no tensorboard package: the JSONL log only
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value, step: int):
        self.f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), step)

    def flush(self):
        self.f.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()


class Silent:
    """The log and the scalar writer of a data-parallel rank other than
    rank 0, which writes nothing: `IOStream`'s and `ScalarWriter`'s calls,
    doing nothing."""

    def cprint(self, text: str):
        pass

    def add_scalar(self, tag: str, value, step: int):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def init_logger(log_dir: str, cfg, phase: Optional[str] = None) -> IOStream:
    os.makedirs(log_dir, exist_ok=True)
    phase = phase or getattr(cfg, "phase", "train")
    logger = IOStream(os.path.join(log_dir, f"log_{phase}.txt"))
    logger.cprint("------------ Options -------------")
    opts = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else vars(cfg)
    for k, v in sorted(opts.items()):
        logger.cprint(f"{k}: {v}")
    logger.cprint("-------------- End ----------------\n")
    return logger
