"""Fault-tolerant training driver (the port of ``repro.training.trainer``).

``run_training`` owns the whole loop: init-or-restore, the train step,
async checkpoints, straggler monitoring, and crash recovery.
``FailureInjector`` lets tests kill the "process" at a chosen step and
prove the restart path reproduces the exact no-failure trajectory
(deterministic pipeline + exact checkpoint restore).

Parameters are drawn by the port's ``init_params`` from a
``torch.Generator`` on the run's device, seeded with
``TrainerConfig.seed``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import init_params
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import ActSharding
from repro_torch.relational.table import resolve_device
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optim import AdamW
from repro_torch.training.train_step import TrainStepConfig, make_train_step


class SimulatedFailure(RuntimeError):
    """Stands in for a host/pod loss in tests."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None
    fired: bool = False

    def maybe_fail(self, step: int):
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.fired):
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerMonitor:
    """Flags steps slower than ``factor`` x running median."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times: List[float] = []
        self.events: List[Dict[str, float]] = []

    def observe(self, step: int, dt: float):
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return
        med = float(np.median(self.times[-50:]))
        if dt > self.factor * med:
            self.events.append({"step": step, "dt": dt, "median": med})


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    microbatches: int = 1
    remat: bool = False
    lr: float = 3e-4
    seed: int = 0
    keep: int = 3


def run_training(
    cfg: ArchConfig,
    tcfg: TrainerConfig,
    pipeline,
    injector: Optional[FailureInjector] = None,
    sh: Optional[ActSharding] = None,
    device=None,
) -> Dict[str, Any]:
    """One training 'process' on ``device`` (``None`` means the CUDA
    card).  Raises SimulatedFailure if injected."""
    device = resolve_device(device)
    opt = AdamW(lr=tcfg.lr)
    mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
    monitor = StragglerMonitor()

    latest = mgr.latest_step()
    if latest is None:
        gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        params = init_params(cfg, gen, device)
        opt_state = opt.init(params)
        start = 0
    else:
        aparams = init_params(cfg, device="meta")
        state_tree = mgr.restore(latest, {"p": aparams,
                                          "o": opt.init(aparams)}, device)
        params, opt_state = state_tree["p"], state_tree["o"]
        start = latest

    step_fn = make_train_step(
        cfg, opt, TrainStepConfig(microbatches=tcfg.microbatches,
                                  remat=tcfg.remat), sh=sh)

    losses: List[float] = []
    for step in range(start, tcfg.steps):
        if injector is not None:
            injector.maybe_fail(step)
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 pipeline.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.observe(step, time.perf_counter() - t0)
        next_step = step + 1
        if next_step % tcfg.ckpt_every == 0 or next_step == tcfg.steps:
            mgr.save(next_step, {"p": params, "o": opt_state})
    mgr.wait()
    return {"losses": losses, "final_params": params,
            "straggler_events": monitor.events, "start": start}


def run_with_recovery(cfg: ArchConfig, tcfg: TrainerConfig, pipeline,
                      injector: Optional[FailureInjector] = None,
                      max_restarts: int = 3, device=None) -> Dict[str, Any]:
    """Supervisor loop: restart from the last checkpoint after failures."""
    attempts = 0
    all_losses: Dict[int, float] = {}
    restarts = 0
    while True:
        try:
            out = run_training(cfg, tcfg, pipeline, injector, device=device)
            for i, l in enumerate(out["losses"]):
                all_losses[out["start"] + i] = l
            out["losses_by_step"] = all_losses
            out["restarts"] = restarts
            return out
        except SimulatedFailure:
            attempts += 1
            restarts += 1
            if attempts > max_restarts:
                raise
