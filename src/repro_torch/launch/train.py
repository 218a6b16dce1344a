"""End-to-end trainer: the BladeDISC++ dynamic-shape path.

``train(mode="dynamic")`` traces the train step once with symbolic
``(b, s)``; the op scheduler, the memory plan and runtime remat then run
every variable-shape batch of the data pipeline without recompilation or
padding (paper §2/§3), under an optional memory limit, with checkpoints,
resume and a straggler monitor.  Port of ``repro/launch/train.py``; its
``compiled`` mode (jit + mesh sharding) is not ported yet.

Usage (on the card; ``--device cpu --smoke`` runs on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-1b \\
        --smoke --steps 50 --memory-limit-mb 200
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config, get_smoke_config
from ..core import TensorSpec, optimize, spec_like, symbolic_dims
from ..core.api import resolve_device
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
    new one."""
    B, S = symbolic_dims("b, s")
    return optimize(make_train_step(cfg), spec_like(params),
                    spec_like(opt_state), batch_specs(B, S),
                    donate_inputs=True, device=device)


def train(cfg, *, steps: int = 50, batch_size: int = 8, mode: str = "dynamic",
          memory_limit: Optional[int] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, resume: bool = True, data_mode: str = "dynamic",
          log_every: int = 10, seed: int = 0,
          device: Any = None) -> Dict[str, Any]:
    """Train ``steps`` steps (counting those of a resumed checkpoint) on
    ``device`` (``cuda`` unless given).  Returns the losses, useful
    tokens, the largest planned ``device_peak``, recompilations, wall
    seconds, tokens/s and, with ``ckpt_dir``, each save's bytes and
    seconds."""
    if mode != "dynamic":
        raise NotImplementedError(
            f"train(mode={mode!r}): the compiled path (jit + mesh sharding "
            f"in the reference) is not ported yet (ROADMAP A6, distributed "
            f"and launch tooling)")
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
    stats: Dict[str, Any] = {"losses": [], "tokens": 0, "peak_bytes": 0,
                             "recompilations": 0}
    dyn = build_dynamic_step(cfg, params, opt_state, device=dev)
    if memory_limit:
        dyn = dyn.with_memory_limit(memory_limit)

    t0 = time.time()
    for step in range(start_step, steps):
        raw = pipe.next_batch()
        args = [params, opt_state, to_device(raw, dev)]
        del params, opt_state     # donated: the step frees the old state
        ts = time.time()
        loss, params, opt_state = dyn.call_donated(args)
        loss = float(loss)        # waits for the card
        dt = time.time() - ts
        stats["peak_bytes"] = max(stats["peak_bytes"],
                                  dyn.last_report.stats.device_peak)
        monitor.record_step({0: dt})
        stats["losses"].append(loss)
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
    ap.add_argument("--memory-limit-mb", type=int, default=0)
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
