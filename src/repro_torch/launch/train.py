"""End-to-end trainer.  Port of ``repro/launch/train.py``.

Two execution paths share the data pipeline, the optimizer, checkpoints,
resume and the straggler monitor:

  * ``dynamic`` -- the BladeDISC++ path: the train step is traced once
    with symbolic ``(b, s)``; the op scheduler, the memory plan and
    runtime remat then run every variable-shape batch of the data
    pipeline without recompilation or padding (paper §2/§3), under an
    optional memory limit;
  * ``compiled`` -- one static plan per batch shape, the counterpart of
    the reference's ``jax.jit`` per shape: ``optimize`` of the step at
    the batch's concrete shape, the parameters and moments donated,
    cached by ``tokens.shape``; every new shape is a recompilation.

Usage (on the card; ``--device cpu --smoke`` runs on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-1b \\
        --smoke --steps 50 --memory-limit-mb 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-1b \\
        --smoke --steps 20 --mode compiled --data-mode bucketed
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config, get_smoke_config
from ..core import TensorSpec, optimize, spec_like, symbolic_dims
from ..core.api import resolve_device
from ..core.scheduling.memsim import simulate_peak_bound
from ..data import DataPipeline, PipelineConfig
from ..distributed import StragglerMonitor
from ..models import init_params
from ..optim import init_state
from .steps import adamw_config_for, make_train_step

BATCH_KEYS = ("tokens", "labels", "mask")


def batch_specs(b: Any, s: Any) -> Dict[str, TensorSpec]:
    """The pipeline batch's specs: ``tokens``/``labels`` int32 and
    ``mask`` float32, each ``(b, s)`` (ints or ``SymDim``s)."""
    return {"tokens": TensorSpec((b, s), torch.int32),
            "labels": TensorSpec((b, s), torch.int32),
            "mask": TensorSpec((b, s), torch.float32)}


def to_device(raw: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) as the step's tensors on ``device``."""
    return {k: torch.from_numpy(raw[k]).to(device) for k in BATCH_KEYS}


def build_dynamic_step(cfg, params, opt_state, *, device: Any = None):
    """Symbolically trace the train step once; runs any (B, S).

    The state is donated: call it through ``call_donated`` with no other
    reference to the state, or the old state stays allocated beside the
    new one.  The step is the flat graph (``scan_layers=False``): the
    symbolic optimizer's scheduling and remat own the memory plan, as in
    the reference."""
    B, S = symbolic_dims("b, s")
    cfg = dataclasses.replace(cfg, scan_layers=False)
    return optimize(make_train_step(cfg), spec_like(params),
                    spec_like(opt_state), batch_specs(B, S),
                    donate_inputs=True, device=device)


class CompiledSteps:
    """The ``compiled`` mode's step: one static plan per batch shape,
    built on the first batch of that shape (``optimize`` of
    ``make_train_step(cfg)`` at the concrete ``(b, s)``, the state
    donated; the config's ``scan_layers`` and ``remat_policy`` as given,
    by default each block recomputed in the backward as under the
    reference's ``jax.jit``) and cached by ``tokens.shape``.  ``plans``, ``compile_s``
    and ``guaranteed_peak_bytes`` are keyed by that shape: a static plan
    declares no dim range, so ``optimize`` states no bound; the bound
    here is the planner's over the plan's one shape (the schedule's
    peak, donation counted), which every call's ``device_peak`` meets."""

    def __init__(self, cfg, params, opt_state, *, device: Any = None):
        self.cfg = cfg
        self.state_specs = (spec_like(params), spec_like(opt_state))
        self.device = device
        self.plans: Dict[Tuple[int, ...], Any] = {}
        self.compile_s: Dict[Tuple[int, ...], float] = {}
        self.guaranteed_peak_bytes: Dict[Tuple[int, ...], int] = {}

    def plan_for(self, batch: Dict[str, torch.Tensor]):
        key = tuple(batch["tokens"].shape)
        fn = self.plans.get(key)
        if fn is None:
            t0 = time.perf_counter()
            fn = optimize(make_train_step(self.cfg), *self.state_specs,
                          batch_specs(*key), donate_inputs=True,
                          device=self.device)
            self.plans[key] = fn
            self.compile_s[key] = time.perf_counter() - t0
            self.guaranteed_peak_bytes[key] = simulate_peak_bound(
                fn.plan.graph, fn.plan.order, fn.plan.shape_graph,
                donate_inputs=True)[1]
        return fn


def train(cfg, *, steps: int = 50, batch_size: int = 8, mode: str = "dynamic",
          memory_limit: Optional[int] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, resume: bool = True, data_mode: str = "dynamic",
          log_every: int = 10, seed: int = 0,
          device: Any = None) -> Dict[str, Any]:
    """Train ``steps`` steps (counting those of a resumed checkpoint) on
    ``device`` (``cuda`` unless given).  Returns the losses, each step's
    ms (the step's call, a plan's build excluded), useful tokens, the
    largest planned ``device_peak``, recompilations, wall seconds,
    tokens/s and, with ``ckpt_dir``, each save's bytes and seconds.  ``mode="compiled"`` plans each batch shape apart
    (:class:`CompiledSteps`; ``recompilations`` counts the shapes, and
    ``steps_by_shape`` holds the step) and ignores ``memory_limit``, as
    the reference's ``jax.jit`` path does."""
    if mode not in ("dynamic", "compiled"):
        raise ValueError(f"mode must be 'dynamic' or 'compiled', not "
                         f"{mode!r}")
    dev = resolve_device(device)
    params = init_params(cfg, seed, device=dev)
    opt_state = init_state(params, adamw_config_for(cfg))
    pipe = DataPipeline(PipelineConfig(vocab=cfg.vocab, batch_size=batch_size,
                                       seed=seed, mode=data_mode,
                                       min_tokens=16, max_tokens=96))
    ck = Checkpointer(ckpt_dir, keep=3) if ckpt_dir else None
    start_step = 0
    if ck is not None and resume and ck.latest_step() is not None:
        start_step, state, extra = ck.restore(device=dev)
        params, opt_state = state["params"], state["opt_state"]
        del state
        pipe.restore(extra["pipeline"])
        print(f"[train] resumed from step {start_step}")

    monitor = StragglerMonitor()
    stats: Dict[str, Any] = {"losses": [], "step_ms": [], "tokens": 0,
                             "peak_bytes": 0, "recompilations": 0}
    if mode == "dynamic":
        dyn = build_dynamic_step(cfg, params, opt_state, device=dev)
        if memory_limit:
            dyn = dyn.with_memory_limit(memory_limit)
    else:
        compiled = stats["steps_by_shape"] = CompiledSteps(
            cfg, params, opt_state, device=dev)

    t0 = time.time()
    for step in range(start_step, steps):
        raw = pipe.next_batch()
        batch = to_device(raw, dev)
        if mode == "compiled":
            n_plans = len(compiled.plans)
            dyn = compiled.plan_for(batch)
            stats["recompilations"] += len(compiled.plans) - n_plans
        args = [params, opt_state, batch]
        del params, opt_state, batch  # donated: the step frees the old state
        ts = time.time()
        loss, params, opt_state = dyn.call_donated(args)
        loss = float(loss)        # waits for the card
        dt = time.time() - ts
        stats["peak_bytes"] = max(stats["peak_bytes"],
                                  dyn.last_report.stats.device_peak)
        monitor.record_step({0: dt})
        stats["losses"].append(loss)
        stats["step_ms"].append(1e3 * dt)
        stats["tokens"] += int(raw["mask"].sum())
        if ck is not None and (step + 1) % ckpt_every == 0:
            ck.save(step + 1, {"params": params, "opt_state": opt_state},
                    extra={"pipeline": pipe.state()}, blocking=False)
        if (step + 1) % log_every == 0:
            print(f"[train] step {step+1} loss={loss:.4f} "
                  f"({dt*1000:.0f} ms)", flush=True)
    if ck is not None:
        ck.wait()
        stats["checkpoints"] = list(ck.saves)
    wall = time.time() - t0
    stats["wall_s"] = wall
    stats["tokens_per_s"] = stats["tokens"] / max(wall, 1e-9)
    return stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--mode", choices=["dynamic", "compiled"], default="dynamic")
    ap.add_argument("--data-mode", choices=["dynamic", "bucketed"],
                    default="dynamic")
    ap.add_argument("--memory-limit-mb", type=int, default=0,
                    help="dynamic mode only; compiled ignores it")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu: run on the CPU)")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    stats = train(cfg, steps=args.steps, batch_size=args.batch_size,
                  mode=args.mode, data_mode=args.data_mode,
                  memory_limit=args.memory_limit_mb * 2**20 or None,
                  ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"[train] done: {stats['tokens_per_s']:.0f} tokens/s, "
          f"final loss {stats['losses'][-1]:.4f}, "
          f"peak {stats['peak_bytes']/2**20:.1f} MiB, "
          f"recompiles {stats['recompilations']}")


if __name__ == "__main__":
    main()
