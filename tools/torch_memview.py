"""ASCII memory-timeline viewer on the PyTorch port: plan-predicted vs
actual occupancy (the twin of ``tools/memview.py``).

Renders a :class:`repro_torch.core.obs.TimelineDiff` -- the reconstructed
per-instruction device/arena occupancy of a lowered ``Program`` next to
the compile-time plan's predicted curve -- as a terminal chart.  One row
per instruction: a bar of actual device bytes, a ``|`` marker where the
plan predicted that step to land, and the byte counts.

Importable (``render_timeline(diff, width=...)``) and a CLI over the four
bench archs' smoke train steps (``launch.steps.make_train_step`` with
symbolic ``(b, s)`` batches, the specs of ``tests/test_torch_bench_archs.py``):

    PYTHONPATH=src python tools/torch_memview.py --arch llama2_1b \\
        --env b=8,s=512 [--width 56] [--arena] [--device cpu]

Plans on the card unless ``--device cpu``.  Exit status is 1 when the diff
is not ok (actual arena peak above the guaranteed bound, or unexplained
allocations) -- usable as a gate -- and 2 for an arch with no bench model.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

BENCH_ARCHS = ("llama2_1b", "gemma_2b", "granite_8b", "musicgen_medium")
BATCH_RANGE = (1, 64)          # benchmarks/memplan_bench.py's ranges
SEQ_RANGE = (16, 4096)


def _fmt(b: int) -> str:
    if b >= 1 << 20:
        return f"{b / (1 << 20):8.2f}M"
    if b >= 1 << 10:
        return f"{b / (1 << 10):8.1f}K"
    return f"{b:8d}B"


def render_timeline(diff, width: int = 56, arena: bool = False) -> str:
    """The diff as an ASCII chart, one row per lowered instruction.

    ``arena=True`` plots arena-backed bytes instead of total device
    bytes.  The bar is the *actual* replayed occupancy; the ``|`` marker
    is the plan's prediction for the instruction's schedule step (they
    coincide when the bar ends at the marker)."""
    actual = diff.actual
    pred = diff.predicted_arena if arena else diff.predicted_device
    curve = [(p.arena_in_use if arena else p.device_used)
             for p in actual.points]
    # scale to this env's curves: the whole-range guaranteed bound can be
    # orders of magnitude above any single env and would flatten them
    top = max(curve + list(pred)) or 1

    def col(b: int) -> int:
        return min(width, round(b * width / top))

    kind = "arena" if arena else "device"
    lines: List[str] = [f"memory timeline @ {diff.env} ({kind} bytes, "
                        f"full scale = {top:,})",
                        f"{'idx':>5} {'step':>5} {'op':<8} "
                        f"{'occupancy':<{width + 1}} {'actual':>9} "
                        f"{'plan':>9}"]
    for pt, used in zip(actual.points, curve):
        p = pred[pt.step] if 0 <= pt.step < len(pred) else 0
        bar = list("█" * col(used) + " " * (width - col(used)) + " ")
        mark = col(p)
        bar[mark] = "|" if bar[mark] == " " else "┃"
        lines.append(f"{pt.idx:>5} {pt.step:>5} {pt.opname:<8} "
                     f"{''.join(bar)} {_fmt(used)} {_fmt(p)}")
    lines.append("")
    lines.append(diff.summary())
    for u in diff.unexplained[:10]:
        lines.append(f"  UNEXPLAINED: {u}")
    return "\n".join(lines)


def _parse_env(text: str) -> Dict[str, int]:
    env = {}
    for part in text.split(","):
        k, _, v = part.partition("=")
        env[k.strip()] = int(v)
    return env


def step_and_specs(arch: str):
    """The smoke config's train step and its argument specs, batch
    ``(b, s)`` symbolic; ``None`` for an input mode the bench does not
    model (``vlm``)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import TensorSpec, symbolic_dims
    from repro_torch.launch.specs import opt_specs, params_specs
    from repro_torch.launch.steps import make_train_step

    cfg = dataclasses.replace(get_smoke_config(arch), scan_layers=False)
    B, S = symbolic_dims("b, s")
    if cfg.input_mode == "tokens":
        batch = {"tokens": TensorSpec((B, S), torch.int32),
                 "labels": TensorSpec((B, S), torch.int32)}
    elif cfg.input_mode == "embeddings":
        batch = {"frame_embed": TensorSpec((B, S, cfg.d_model),
                                           torch.float32),
                 "labels": TensorSpec((B, S, cfg.n_codebooks), torch.int32)}
    else:
        return None
    p = params_specs(cfg)
    return make_train_step(cfg), (p, opt_specs(cfg, p), batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama2_1b",
                    help=f"bench arch ({', '.join(BENCH_ARCHS)})")
    ap.add_argument("--env", default="b=8,s=512", metavar="b=8,s=512",
                    help="probe env as dim=value pairs")
    ap.add_argument("--width", type=int, default=56, help="bar width")
    ap.add_argument("--arena", action="store_true",
                    help="plot arena-backed bytes instead of device bytes")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core import optimize

    r = step_and_specs(args.arch)
    if r is None:
        print(f"arch {args.arch!r} has no bench model", file=sys.stderr)
        return 2
    step, specs = r
    fn = optimize(step, *specs,
                  dynamic_dims={"b": BATCH_RANGE, "s": SEQ_RANGE},
                  device=args.device)
    diff = fn.memory_timeline(_parse_env(args.env))
    print(render_timeline(diff, width=args.width, arena=args.arena))
    return 0 if diff.ok else 1


if __name__ == "__main__":
    sys.exit(main())
