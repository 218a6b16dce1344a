"""Paper Table 1 on the PyTorch port: Llama fine-tuning on variable-length
batches (the twin of ``benchmarks/table1_dynamic_training.py``).

Three systems, as in §3 of the paper:
  * ``disc-dynamic``  — dynamic shapes, NO memory optimization (BladeDISC):
                        one symbolic trace, no scheduling, no remat;
  * ``disc-static``   — power-of-two padded buckets, memory optimization
                        with *exact* shapes, recompile per new bucket
                        (BladeDISC static);
  * ``disc++``        — symbolic-shape scheduling + runtime remat, one
                        trace, no padding (BladeDISC++).

Reported per system: tokens/s (useful tokens), exact peak device bytes
(the plan's ``device_peak``), recompilations, padded-token fraction, and
the runtime evictions and offloads summed over the measured steps.  The
memory-limit sweep reproduces the paper's OOM row: at the limit set by
disc++'s smallest-batch peak (+5%), the unoptimized dynamic system OOMs on
larger batches while disc++ keeps fitting, by its schedule alone where
its evictions read 0, else by runtime rematerialization.

Every system runs through ``optimize`` and the VM; on the card the bf16
train step launches the hand-written flash-attention and RMSNorm kernels.
The state is not donated, as in the reference: each step holds the old
and the new weights and moments.

    PYTHONPATH=src python benchmarks/torch_table1_dynamic_training.py
    PYTHONPATH=src python benchmarks/torch_table1_dynamic_training.py --full

Without ``--full``: the reference's smoke settings (smoke llama2_1b,
16–128 tokens, batches 6, 8, 10).  ``--full``: llama2_1b at full width
(4 layers, d_model 4096, bf16 weights, f32 moments) on the paper's
lengths (25–750 tokens), batches 14, 16, 18, writing
``BENCH_torch_table1.json`` with the card's name and power limit.  Runs
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (MemoryLimitExceeded, optimize, spec_like,
                              symbolic_dims)
from repro_torch.core.api import resolve_device
from repro_torch.data import DataPipeline, PipelineConfig
from repro_torch.launch.steps import adamw_config_for, make_train_step
from repro_torch.launch.train import batch_specs, to_device
from repro_torch.models import init_params
from repro_torch.optim import init_state

SYSTEMS = ("disc-dynamic", "disc-static", "disc++")
SMOKE = dict(steps=12, batches=(6, 8, 10), min_tokens=16, max_tokens=128)
# the pipeline's defaults are the paper's lengths (CodeAlpaca-20K, §3)
FULL = dict(steps=12, batches=(14, 16, 18), min_tokens=25, max_tokens=750)
LIMIT_FACTOR = 1.05


def _specs(params, opt_state, b, s):
    return spec_like(params), spec_like(opt_state), batch_specs(b, s)


def _runner_for(system: str, runners: Dict, out: Dict, step, params,
                opt_state, b: int, s: int, memory_limit, device):
    if system == "disc++":
        if "sym" not in runners:
            B, S = symbolic_dims("b, s")
            runners["sym"] = optimize(
                step, *_specs(params, opt_state, B, S),
                memory_limit=memory_limit, device=device)
            out["recompiles"] += 1  # the single symbolic compile
        return runners["sym"]
    if system == "disc-static":
        if (b, s) not in runners:
            runners[(b, s)] = optimize(
                step, *_specs(params, opt_state, b, s),
                memory_limit=memory_limit, device=device)
            out["recompiles"] += 1
        return runners[(b, s)]
    if "base" not in runners:  # disc-dynamic: no scheduling, no remat
        B, S = symbolic_dims("b, s")
        runners["base"] = optimize(
            step, *_specs(params, opt_state, B, S),
            enable_scheduling=False, enable_remat=False,
            memory_limit=memory_limit, device=device)
        out["recompiles"] += 1
    return runners["base"]


def run_system(system: str, cfg, *, batch_size: int, steps: int,
               memory_limit: Optional[int] = None, seed: int = 0,
               warmup: bool = True, min_tokens: int = 16,
               max_tokens: int = 128, params: Optional[Dict] = None,
               device: Any = None) -> Dict[str, Any]:
    """One row of the table.  ``params``: the starting weights (default:
    ``init_params(cfg, seed)``); never modified, the state is not
    donated.  ``device``: ``cuda`` unless given."""
    dev = resolve_device(device)
    step = make_train_step(cfg)
    if params is None:
        params = init_params(cfg, seed, device=dev)
    opt_state = init_state(params, adamw_config_for(cfg))
    mode = "bucketed" if system == "disc-static" else "dynamic"
    pipe = DataPipeline(PipelineConfig(vocab=cfg.vocab, batch_size=batch_size,
                                       seed=seed, mode=mode,
                                       min_tokens=min_tokens,
                                       max_tokens=max_tokens))
    out: Dict[str, Any] = dict(system=system, batch=batch_size, peak=0,
                               recompiles=0, useful_tokens=0, total_tokens=0,
                               evictions=0, offloads=0, losses=[], oom=False,
                               memory_limit=memory_limit)
    runners: Dict[Any, Any] = {}
    try:
        if warmup:
            # prime capture + the allocator over the SAME batch sequence,
            # then measure a steady-state epoch
            saved = pipe.state()
            for _ in range(steps):
                raw = pipe.next_batch()
                b, s = raw["tokens"].shape
                fn = _runner_for(system, runners, out, step, params,
                                 opt_state, b, s, memory_limit, dev)
                fn(params, opt_state, to_device(raw, dev))
            pipe.restore(saved)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.time()
        for _ in range(steps):
            raw = pipe.next_batch()
            b, s = raw["tokens"].shape
            fn = _runner_for(system, runners, out, step, params, opt_state,
                             b, s, memory_limit, dev)
            loss, params, opt_state = fn(params, opt_state,
                                         to_device(raw, dev))
            rep = fn.last_report
            out["peak"] = max(out["peak"], rep.stats.device_peak)
            out["evictions"] += rep.stats.evictions
            out["offloads"] += rep.stats.offloads
            out["losses"].append(float(loss))   # waits for the card
            out["useful_tokens"] += int(raw["mask"].sum())
            out["total_tokens"] += int(raw["tokens"].size)
    except MemoryLimitExceeded:
        out["oom"] = True
        t0 = out.get("_t0", time.time())
    out["wall_s"] = time.time() - t0
    out["tokens_per_s"] = out["useful_tokens"] / max(out["wall_s"], 1e-9)
    out["pad_frac"] = 1.0 - out["useful_tokens"] / max(out["total_tokens"], 1)
    return out


def limit_from(rows: List[Dict[str, Any]]) -> int:
    """The sweep's memory limit: disc++'s smallest-batch peak, +5%."""
    return int(next(r["peak"] for r in rows if r["system"] == "disc++")
               * LIMIT_FACTOR)


def run(cfg=None, *, steps: int = 12, batches=(6, 8, 10),
        min_tokens: int = 16, max_tokens: int = 128,
        params: Optional[Dict] = None,
        device: Any = None) -> List[Dict[str, Any]]:
    cfg = cfg if cfg is not None else get_smoke_config("llama2_1b")
    kw = dict(steps=steps, min_tokens=min_tokens, max_tokens=max_tokens,
              params=params, device=device)
    rows: List[Dict[str, Any]] = []
    # memory-free pass to establish peaks
    for system in SYSTEMS:
        rows.append(run_system(system, cfg, batch_size=batches[0], **kw))
    # the paper's OOM experiment: cap at disc++'s smallest-batch peak (+5%)
    limit = limit_from(rows)
    for b in batches[1:]:
        for system in ("disc-dynamic", "disc++"):
            rows.append(run_system(system, cfg, batch_size=b,
                                   memory_limit=limit, **kw))
    return rows


def format_rows(rows) -> str:
    hdr = (f"{'system':14s} {'batch':>5s} {'tok/s':>8s} {'peak MiB':>9s} "
           f"{'recompiles':>10s} {'pad%':>6s} {'evict':>6s} {'offload':>7s} "
           f"{'status':>7s}")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"{r['system']:14s} {r['batch']:5d} {r['tokens_per_s']:8.0f} "
            f"{r['peak']/2**20:9.1f} {r['recompiles']:10d} "
            f"{100*r['pad_frac']:6.1f} {r['evictions']:6d} "
            f"{r['offloads']:7d} {'OOM' if r['oom'] else 'ok':>7s}")
    return "\n".join(lines)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="llama2_1b at full width, batches 14/16/18, the "
                         "paper's lengths; writes BENCH_torch_table1.json")
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu: run on the CPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    settings = FULL if args.full else SMOKE
    cfg = get_config("llama2_1b") if args.full \
        else get_smoke_config("llama2_1b")
    smi = nvidia_smi() if dev.type == "cuda" else None
    if smi:
        print(smi, flush=True)
    t0 = time.time()
    rows = run(cfg, device=dev, **settings)
    print(format_rows(rows))
    if args.full:
        out = Path(__file__).resolve().parent.parent / "BENCH_torch_table1.json"
        with open(out, "w") as f:
            json.dump({"nvidia_smi": smi, "device": str(dev),
                       "config": cfg.name, "settings": settings,
                       "memory_limit": limit_from(rows),
                       "seconds": time.time() - t0, "rows": rows}, f,
                      indent=1)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
