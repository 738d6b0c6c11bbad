"""Background workload runner: the counterpart of ``tpudash/models/runner.py``.

Runs the demo transformer's train step in a daemon thread and tracks
achieved throughput: steps/s, achieved TFLOP/s (analytic FLOPs ÷ measured
step time), and current loss.  The probe source measures what the card
*can* do; the workload runner shows what it *is* doing.

It trains on every local GPU: over several devices with the dp×tp sharded
step on ``build_mesh(mesh_axes_for(n), devices)``, on one device with the
plain step.  Both are ``graphed.compiled``: on GPUs the step is captured
once, at the first call, as one CUDA graph over every device and replayed
with one launch a step, as the reference dispatches one ``jax.jit``
program a step; on the CPU, which only tests ask for, it runs eagerly.

Given the config of a one-GPU model (:data:`ONE_GPU_MODELS`: a
``DeepseekV2Config`` for DeepSeek-V2-Lite, ``models/deepseek_v2.py``, or a
``KimiLinearConfig`` for Kimi-Linear, ``models/kimi_linear.py``) it trains
that model instead, on one device only (the runner refuses more), and
reports the routing counters of each sync interval beside the step's series.
"""

from __future__ import annotations

import logging
import threading
import time

import torch

from tpudash_torch.models import deepseek_v2, kimi_linear
from tpudash_torch.models.graphed import compiled
from tpudash_torch.models.workload import (
    WorkloadConfig,
    flops_per_step,
    gather_train_state,
    make_sharded_train_step,
    make_train_state,
    shard_plan,
    train_step,
)
from tpudash_torch.parallel.mesh import build_mesh, local_devices, mesh_axes_for

_log = logging.getLogger(__name__)

#: the one-GPU models by their config's class: each module has ``NAME``,
#: ``make_train_state``, ``make_train_step``, ``routing_counters``,
#: ``load_stats`` and ``flops_per_step``
ONE_GPU_MODELS = {deepseek_v2.DeepseekV2Config: deepseek_v2,
                  kimi_linear.KimiLinearConfig: kimi_linear}


def training_devices(device=None, devices=None) -> list[torch.device]:
    """The devices the workload trains on: ``[device]``, else ``devices``
    (a device named twice stands in for two), else every local GPU; without
    a GPU and without devices it raises, never picks the CPU."""
    if device is not None and devices is not None:
        raise ValueError("pass device or devices, not both")
    if device is not None:
        return [torch.device(device)]
    if devices is not None:
        if not devices:
            raise ValueError("devices is empty")
        return [torch.device(d) for d in devices]
    return local_devices()


class WorkloadRunner:
    def __init__(
        self,
        cfg: WorkloadConfig | None = None,
        steps_per_sync: int = 8,
        checkpoint_dir: str = "",
        checkpoint_every: int = 0,
        device: "torch.device | str | None" = None,
        devices: "list | None" = None,
    ):
        self.cfg = cfg or WorkloadConfig()
        self.devices = training_devices(device, devices)
        #: the one-GPU model's module, None for the demo model
        self.model = ONE_GPU_MODELS.get(type(self.cfg))
        if self.model is not None and len(self.devices) > 1:
            raise ValueError(
                f"the {self.model.NAME} workload trains on one GPU, not {len(self.devices)}: "
                "its experts are not sharded over GPUs yet; give it one device "
                "(CUDA_VISIBLE_DEVICES) or train the demo model")
        #: dispatch this many steps back to back before one host readback:
        #: a per-step readback would idle the card between steps
        self.steps_per_sync = max(1, steps_per_sync)
        #: checkpoint/resume (models/checkpoint.py): save every N steps into
        #: checkpoint_dir and resume from its latest step on start.  Empty
        #: dir or N=0 disables.
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(0, checkpoint_every)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # telemetry (read under lock)
        self.steps = 0
        self.loss = float("nan")
        self.step_time_ema = float("nan")  # seconds
        self.error: str | None = None
        self.resumed_from: int | None = None
        #: a one-GPU model: routing series of the last sync interval
        self.routing: dict = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "WorkloadRunner":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="tpudash-workload", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- training loop -------------------------------------------------------
    def _loop(self) -> None:
        try:
            cfg, devs = self.cfg, self.devices
            dev = devs[0]
            model = self.model
            params, optimizer = (model.make_train_state if model else make_train_state)(
                cfg, torch.Generator(device=dev).manual_seed(0)
            )
            counters = model.routing_counters(cfg, dev) if model else None

            # checkpointing is best-effort: an unwritable dir, a corrupt
            # checkpoint or one of another package must degrade to "train
            # without checkpoints", never kill the workload
            ckptr = None
            if self.checkpoint_dir and self.checkpoint_every:
                try:
                    from tpudash_torch.models.checkpoint import WorkloadCheckpointer

                    ckptr = WorkloadCheckpointer(self.checkpoint_dir)
                    restored = ckptr.restore_latest(params, optimizer)
                except Exception as e:  # noqa: BLE001
                    _log.warning("checkpointing disabled: %s", e)
                    ckptr, restored = None, None
                if restored is not None:
                    step0 = restored[2]
                    with self._lock:
                        self.steps = step0
                        self.resumed_from = step0

            if len(devs) > 1:  # a mesh error (batch % dp, …) surfaces as self.error
                mesh = build_mesh(mesh_axes_for(len(devs)), devs)
                plan = shard_plan(mesh, cfg)
                step, shard_inputs = make_sharded_train_step(mesh, cfg)
                params, optimizer = shard_inputs(params, optimizer)

                def full_state():  # a checkpoint holds the gathered state
                    return gather_train_state(params, optimizer, plan)
            elif model:
                step = model.make_train_step(cfg, dev, counters)

                def full_state():
                    return params, optimizer
            else:
                step = compiled(lambda p, o, t: train_step(p, o, t, cfg))

                def full_state():
                    return params, optimizer

            shape = (cfg.batch, cfg.seq)
            data_gen = torch.Generator(device=dev).manual_seed(1)
            k = self.steps_per_sync
            last_saved = self.steps
            last_counts = [0] * (cfg.n_held + 1) if model else None
            while not self._stop.is_set():
                t0 = time.perf_counter()
                loss = None
                for _ in range(k):  # dispatch k steps, sync once
                    tokens = torch.randint(0, cfg.vocab, shape, generator=data_gen, device=dev)
                    # the first call captures the graph on GPUs: a failed
                    # capture surfaces as self.error
                    loss = step(params, optimizer, tokens)
                loss_val = loss.item()  # readback = true batch boundary
                dt = (time.perf_counter() - t0) / k
                routing = None
                if counters is not None:  # read after the sync: no extra one
                    now = counters.tolist()
                    delta = [a - b for a, b in zip(now, last_counts)]
                    routing = model.load_stats(delta[:-1], delta[-1], cfg)
                    last_counts = now
                with self._lock:
                    if routing is not None:
                        self.routing = routing
                    self.steps += k
                    self.loss = loss_val
                    self.step_time_ema = (
                        dt
                        if self.step_time_ema != self.step_time_ema  # NaN
                        else 0.7 * self.step_time_ema + 0.3 * dt
                    )
                if ckptr and self.steps - last_saved >= self.checkpoint_every:
                    try:
                        ckptr.save(self.steps, *full_state())
                        last_saved = self.steps
                    except Exception as e:  # noqa: BLE001 — disk full etc.
                        _log.warning("checkpoint save failed, disabling: %s", e)
                        ckptr = None
            if ckptr and self.steps > last_saved:
                try:
                    ckptr.save(self.steps, *full_state())  # final save
                except Exception as e:  # noqa: BLE001
                    _log.warning("final checkpoint save failed: %s", e)
        except Exception as e:  # surface crashes to the source, don't die mute
            with self._lock:
                self.error = f"workload crashed: {e}"

    # -- telemetry -----------------------------------------------------------
    def metrics(self) -> dict:
        with self._lock:
            if self.error:
                raise RuntimeError(self.error)
            st = self.step_time_ema
            ok = st == st and st > 0
            if self.model:
                per = self.routing.get("moe_tokens_per_held_expert")
                flops = self.model.flops_per_step(self.cfg, sum(per) if per else None)
            else:
                flops = flops_per_step(self.cfg)
            return {
                **self.routing,
                "steps": self.steps,
                "resumed_from": self.resumed_from,
                "loss": self.loss,
                "steps_per_second": (1.0 / st) if ok else 0.0,
                "achieved_tflops": flops / st / 1e12 if ok else 0.0,
            }
