"""Experiment logging: stdout + JSONL run records, wandb-optional (a
copy of ``gsn_tpu/train/logging.py``; ``watch`` takes a module).

The reference logs realtime per-epoch metrics and run summaries to
wandb (``main.py:61-64,400-459``; ``train_test_funcs.py:150-159``).
Without the wandb package the sink is a JSONL file per run (one line
per logged step plus a final summary line) with the same keys; a wandb
sink activates automatically when the package is
importable and ``use_wandb=True``.  ``realtime`` mirrors the reference's
``--wandb_realtime``: when off, per-step records are buffered and
flushed to wandb at close (reference main.py:400-428); JSONL always
writes immediately.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple


class RunLogger:
    def __init__(self, run_dir: Optional[str] = None,
                 use_wandb: bool = False, project: str = "gsn_tpu",
                 entity: Optional[str] = None, realtime: bool = True,
                 config: Optional[Dict[str, Any]] = None):
        self.run_dir = run_dir
        self.realtime = realtime
        self._fh = None
        self._buffer: List[Tuple[Dict[str, Any], Optional[int]]] = []
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, "log.jsonl"), "a")
            if config is not None:
                with open(os.path.join(run_dir, "params.json"), "w") as f:
                    json.dump(config, f, indent=2, default=str)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=project, entity=entity, config=config)
                self._wandb = wandb
            except Exception:
                pass   # degrade to JSONL-only (wandb absent / no network)
        self.summary: Dict[str, Any] = {}

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        rec = {"ts": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        if self._fh:
            self._fh.write(json.dumps(rec, default=float) + "\n")
            self._fh.flush()
        if self._wandb:
            if self.realtime:
                self._wandb.log(metrics, step=step)
            else:
                self._buffer.append((metrics, step))

    def watch(self, model) -> Dict[str, int]:
        """Counterpart of ``wandb.watch(model)`` (reference main.py:296):
        records the model's parameter inventory — per-parameter sizes and
        the total count — as one log record (wandb's gradient/weight
        histograms have no offline analogue; the param census is the
        durable part).  ``model`` is a ``torch.nn.Module``; BN running
        statistics are buffers, not parameters, so the total is the
        reference package's flax ``params`` census."""
        shapes: Dict[str, int] = {n: p.numel()
                                  for n, p in model.named_parameters()}
        total = sum(shapes.values())
        self.log({"watch_num_params": total,
                  "watch_param_shapes": shapes})
        return {"num_params": total, **shapes}

    def set_summary(self, **kv):
        self.summary.update(kv)
        if self._wandb:
            for k, v in kv.items():
                self._wandb.run.summary[k] = v

    def close(self):
        if self._fh:
            self._fh.write(json.dumps(
                {"summary": self.summary}, default=float) + "\n")
            self._fh.close()
            self._fh = None
        if self._wandb:
            for metrics, step in self._buffer:
                self._wandb.log(metrics, step=step)
            self._buffer.clear()
            self._wandb.finish()
