"""Time ``chip_smoke.py``'s phase 22 (the dry-run) alone, for one or more
checkouts of the repo, on one card.

Each checkout runs in its own process, from its own ``chip_smoke.py`` and
``src/``: the kernels built (phase 1's ``phase_device``), the two things
phase 22 (b) takes from earlier phases made the way those phases make
them (phase 6's train plan of ``llama2_1b`` at full width with symbolic
``(b, s)``, donated, and phase 21 (b)'s FLOPs of that plan at (8, 1024)),
then ``phase_dryrun()`` timed.  Give the checkouts in the order they
should run, e.g. parent, change, change, parent, to compare two trees on
one host::

    python tools/torch_dryrun_phase.py build/parent . . build/parent

Prints the card's name and power limit, each run's ``[dryrun]`` lines
(cut to 1500 characters) and ``[phase22]`` line (seconds of phase 22, of
its part (a) and of the cells in it) and, as its last line, a JSON list
of those rows.  Exits non-zero if any run fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# run inside a checkout's root: its chip_smoke module, its src/
ONE = r"""
import dataclasses, json, sys, time
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs.llama2_1b import CONFIG
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.launch.graph_analysis import analyze_graph
from repro_torch.launch.steps import adamw_config_for, make_train_step
from repro_torch.models import init_params
from repro_torch.optim import init_state
import torch
cs.phase_device()
params = init_params(CONFIG, seed=0, device="cuda")
opt_state = init_state(params, adamw_config_for(CONFIG))
B, S = symbolic_dims("b, s")
batch = {k: TensorSpec((B, S), torch.int32) for k in ("tokens", "labels")}
# phase 6's flat graph (a checkout before the field has only that one)
cfg = dataclasses.replace(CONFIG, scan_layers=False) \
    if hasattr(CONFIG, "scan_layers") else CONFIG
opt = optimize(make_train_step(cfg), spec_like(params),
               spec_like(opt_state), batch, dynamic_dims=cs.DYNAMIC_DIMS,
               donate_inputs=True)
b, s = cs.TRAIN_SHAPES[-1]
cs.DRYRUN_BASE["opt"] = opt
cs.DRYRUN_BASE["flops"] = analyze_graph(opt.plan.graph,
                                        {"b": b, "s": s})["flops"]
del params, opt_state, opt
torch.cuda.empty_cache()
rows = {}
real = cs.dryrun_cell
def timed_cell():
    t0 = time.perf_counter()
    row = real()
    rows["a"] = time.perf_counter() - t0
    rows["train_cell"] = row["seconds"]
    rows["decode_cell"] = row.get("decode_seconds")
    rows["moe_cells"] = row.get("moe_seconds")
    return row
cs.dryrun_cell = timed_cell
t0 = time.perf_counter()
cs.phase_dryrun()
rows["phase22"] = time.perf_counter() - t0
print("PHASE22 " + json.dumps(rows))
"""


def main(argv=None) -> int:
    roots = [Path(r).resolve() for r in (argv or sys.argv[1:])]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[phase22] card {smi}", flush=True)
    rows, failed = [], False
    for root in roots:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", ONE], cwd=root,
                              capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        found = [x for x in lines if x.startswith("PHASE22 ")]
        for x in lines:
            if x.startswith("[dryrun]"):
                print(x[:1500], flush=True)
        row = {"root": str(root), "rc": proc.returncode,
               "process_s": time.perf_counter() - t0}
        if found:
            row.update(json.loads(found[-1][8:]))
        else:
            failed = True
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
        rows.append(row)
        print(f"[phase22] {json.dumps(row)}", flush=True)
    print(json.dumps(rows))
    return 1 if failed or any(r["rc"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
