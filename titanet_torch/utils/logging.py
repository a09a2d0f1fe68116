"""Observability: console tables, JSONL metric sink, TensorBoard event
files, W&B adapter and the data/model step timer (the port's own copy of
``titanet_tpu/utils/logging.py``; ``rich`` and ``wandb`` are imported only
when a logger that uses them is enabled).

Rebuild of the reference's three sinks (SURVEY.md §5: rich console tables
``src/learn.py:22-61``, W&B scalars/images ``src/learn.py:176-177`` +
``src/utils.py:406-418``, figure PNGs) plus a JSONL sink the reference
lacked (greppable local metric history, no network dependency).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch


class ConsoleLogger:
    """Step/epoch tables (reference log_step/log_epoch, src/learn.py:22-61)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._console = None
        if enabled:
            try:
                from rich.console import Console

                self._console = Console()
            except ImportError:
                self._console = None

    def _table(self, columns, row):
        if self._console is None:
            print(" | ".join(f"{c}={v}" for c, v in zip(columns, row)), flush=True)
            return
        from rich.table import Table

        table = Table(show_header=True, header_style="bold")
        for c in columns:
            table.add_column(c)
        table.add_row(*[str(v) for v in row])
        self._console.print(table)

    def log_step(self, split, epoch, total_epochs, step, total_steps, loss, times: Dict):
        if not self.enabled:
            return
        cols = ["SPLIT", "EPOCH", "STEP", "LOSS"] + [f"{k.upper()} TIME" for k in times]
        row = [split.capitalize(), f"{epoch} / {total_epochs}", f"{step} / {total_steps}",
               f"{loss:.2f}"] + [f"{v:.2f}" for v in times.values()]
        self._table(cols, row)

    def log_epoch(self, split, epoch, total_epochs, metrics: Dict):
        if not self.enabled:
            return
        cols = ["SPLIT", "EPOCH"] + [
            k.replace(f"{split}/", "").upper() for k in metrics
        ]
        row = [split.capitalize(), f"{epoch} / {total_epochs}"] + [
            f"{v:.4f}" if isinstance(v, float) else str(v) for v in metrics.values()
        ]
        self._table(cols, row)


class JsonlLogger:
    """Append metrics as JSON lines (new vs the reference)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, metrics: Dict, step: Optional[int] = None):
        if not self.path:
            return
        record = {"ts": time.time()}
        if step is not None:
            record["epoch"] = step
        record.update(
            {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        )
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class TensorBoardLogger:
    """TensorBoard event-file sink (beyond the reference, whose only
    remote sink — W&B, src/utils.py:406-418 — needs a live server).
    Writes stock ``events.out.tfevents.*`` files via the dependency-free
    writer in tb_events.py; scalars and per-epoch embedding figures land
    in ``<logdir>`` and are verifiable locally with
    ``tb_events.read_events``."""

    def __init__(self, logdir: Optional[str]):
        self.writer = None
        if logdir:
            from titanet_torch.utils.tb_events import EventFileWriter

            self.writer = EventFileWriter(logdir)

    def log(self, metrics: Dict, step: Optional[int] = None):
        if self.writer is not None:
            self.writer.add_scalars(metrics, step=step or 0)
            self.writer.flush()

    def log_image(self, key: str, path: str, step: Optional[int] = None):
        if self.writer is not None:
            self.writer.add_image(key, path, step=step or 0)
            self.writer.flush()

    def finish(self):
        if self.writer is not None:
            self.writer.close()


class WandbLogger:
    """W&B adapter (reference init_wandb, src/utils.py:406-418). Degrades to
    a no-op when the wandb package or API key is unavailable."""

    def __init__(self, enabled=False, api_key_file=None, project="titanet",
                 entity=None, name=None, config=None):
        self.run = None
        if not enabled:
            return
        try:
            import wandb

            if api_key_file and os.path.exists(api_key_file):
                os.environ["WANDB_API_KEY"] = open(api_key_file).read().strip()
            self.run = wandb.init(name=name, project=project, entity=entity, config=config)
        except Exception as e:  # offline/missing package: degrade gracefully
            print(f"[wandb disabled: {e}]")

    def log(self, metrics: Dict, step: Optional[int] = None):
        if self.run is not None:
            self.run.log(metrics, step=step)

    def log_image(self, key: str, path: str, step: Optional[int] = None):
        """Push a saved figure into the run (reference logs per-epoch
        embedding scatter figures, src/learn.py:401-406)."""
        if self.run is not None:
            import wandb

            self.run.log({key: wandb.Image(path)}, step=step)

    def save(self, path: str):
        if self.run is not None:
            self.run.save(path)

    def set_notes(self, text: str):
        if self.run is not None:
            self.run.notes = text

    def finish(self):
        if self.run is not None:
            self.run.finish()


class StepTimer:
    """Data/model time split per step (reference timing harness,
    src/learn.py:85-135), aggregated per epoch. "data" is the host's time
    in the feed. On a CUDA ``device`` "model" is the device time of each
    step: a pair of CUDA events on the current stream around it, read when
    the epoch's totals are (:meth:`epoch_metrics`, :meth:`total`), so no
    step waits for the card; a host clock there would read the enqueue of a
    captured step. Elsewhere both are host wall time."""

    def __init__(self, device=None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._t0: Optional[float] = None
        self._phase: Optional[str] = None
        self._device = torch.device(device) if device is not None and torch.device(device).type == "cuda" else None
        self._events: list = []  # [start, end] CUDA events of each "model" phase not yet read

    def _record(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    def start(self, phase: str):
        now = time.perf_counter()
        if self._phase is not None and self._t0 is not None:
            if self._device is not None and self._phase == "model":
                self._events[-1].append(self._record())
            else:
                self.totals[self._phase] = self.totals.get(self._phase, 0.0) + now - self._t0
            self.counts[self._phase] = self.counts.get(self._phase, 0) + 1
        if self._device is not None and phase == "model":
            self._events.append([self._record()])
        self._phase, self._t0 = phase, now

    def stop(self):
        self.start("_idle")
        self._phase = None

    def _read_events(self) -> None:
        """Add the device time of every ended "model" phase (waits for the
        last one's end)."""
        ended = [pair for pair in self._events if len(pair) == 2]
        if not ended:
            return
        ended[-1][1].synchronize()
        self.totals["model"] = self.totals.get("model", 0.0) + 1e-3 * sum(a.elapsed_time(b) for a, b in ended)
        self._events = [pair for pair in self._events if len(pair) < 2]

    def total(self, phase: str) -> float:
        """Seconds in ``phase`` over the phases ended so far."""
        self._read_events()
        return self.totals.get(phase, 0.0)

    def epoch_metrics(self, prefix: str) -> Dict[str, float]:
        self._read_events()
        out = {}
        for phase, total in self.totals.items():
            if phase.startswith("_"):
                continue
            n = max(self.counts.get(phase, 1), 1)
            out[f"{prefix}/total_{phase}_time"] = total
            out[f"{prefix}/avg_{phase}_time"] = total / n
        return out
