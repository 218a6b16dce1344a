"""Quickstart on the PyTorch port: the BladeDISC++ pipeline on a
dynamic-shape MLP train step (the twin of ``examples/quickstart.py``).

The same steps, prints and asserts as the reference; the inputs come from
``np.random.RandomState(0)`` in the reference's order, so the printed
losses are the reference's.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (MemoryLimitExceeded, TensorSpec, optimize,
                              resolve_device, symbolic_dims)

LAYERS, D, F_ = 6, 64, 512
SHAPES = [(2, 17), (5, 128), (3, 61)]


def loss_fn(ws, x):
    h = x
    for w1, w2 in ws:
        h = h + F.gelu(h @ w1, approximate="tanh") @ w2   # jax.nn.gelu
    return (h ** 2).mean()


def train_step(ws, x):
    """``(loss, ws - 1e-3 * grads)``, the reference's ``value_and_grad``."""
    with torch.enable_grad():
        leaves = [[w.detach().requires_grad_() for w in pair] for pair in ws]
        loss = loss_fn(leaves, x)
        grads = torch.autograd.grad(loss, [w for pair in leaves
                                           for w in pair])
    it = iter(grads)
    return loss.detach(), [tuple(w - 1e-3 * next(it) for w in pair)
                           for pair in ws]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    f32 = torch.float32

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # 1. Declare symbolic dims: batch and sequence vary at runtime.
    B, S = symbolic_dims("b, s")

    # 2. Optimize once: symbolic trace -> op scheduling (§2.2) -> remat
    #    plan (§2.3).
    w_specs = [(TensorSpec((D, F_), f32), TensorSpec((F_, D), f32))
               for _ in range(LAYERS)]
    opt = optimize(train_step, w_specs, TensorSpec((B, S, D), f32),
                   device=dev)
    r = opt.report
    print(f"compiled once: {len(opt.plan.order)} ops, "
          f"{r.schedule.symbolic_decisions} symbolic scheduling decisions, "
          f"{r.n_candidates} remat candidates ({r.n_recomputable} "
          f"recomputable)")

    # 3. Run ANY shape with the same plan — no retracing, no padding.
    rng = np.random.RandomState(0)
    ws = [(t(rng.randn(D, F_) * 0.05), t(rng.randn(F_, D) * 0.05))
          for _ in range(LAYERS)]
    losses = []
    for (b, s) in SHAPES:
        x = t(rng.randn(b, s, D))
        loss, _ = opt(ws, x)
        peak = opt.last_report.stats.device_peak
        losses.append(float(loss))
        print(f"shape ({b:2d},{s:4d}): loss={float(loss):8.4f} "
              f"peak={peak/2**20:6.2f} MiB")

    # 4. Cap memory: the runtime evicts + rematerializes; numerics
    #    unchanged.
    x = t(rng.randn(6, 256, D))
    loss_free, _ = opt(ws, x)
    peak = opt.last_report.stats.device_peak
    print(f"free-run peak at (6,256): {peak/2**20:.2f} MiB "
          f"(loss={float(loss_free):.4f})")
    for frac in (0.8, 0.6, 0.45):
        capped = opt.with_memory_limit(int(peak * frac))
        try:
            loss_c, _ = capped(ws, x)
        except MemoryLimitExceeded:
            print(f"  {100*frac:3.0f}% cap: infeasible (single-op floor "
                  f"reached)")
            break
        st = capped.last_report.stats
        assert abs(float(loss_c) - float(loss_free)) < 1e-5
        print(f"  {100*frac:3.0f}% cap: peak={st.device_peak/2**20:6.2f} MiB"
              f"  evictions={st.evictions:3d} recomputes={st.recomputes:3d} "
              f"offloads={st.offloads:2d}  (numerics unchanged)")

    # 5. Bounded dynamic shapes: declared dim ranges resolve more
    #    scheduling decisions symbolically and give a compile-time
    #    worst-case peak guarantee.
    opt_b = optimize(train_step, w_specs, TensorSpec((B, S, D), f32),
                     dynamic_dims={"b": (1, 8), "s": "<=256"}, device=dev)
    frac = opt_b.report.schedule.decision_symbolic_fraction
    print(f"declared 1<=b<=8, s<=256: guaranteed peak <= "
          f"{opt_b.guaranteed_peak_bytes/2**20:.2f} MiB, "
          f"{100*frac:.1f}% of scheduling decisions symbolic")
    x = t(rng.randn(8, 256, D))
    opt_b(ws, x)
    assert opt_b.last_report.stats.device_peak <= \
        opt_b.guaranteed_peak_bytes

    # 6. Memory planner (memory_plan="arena", on by default): every run
    #    draws from a planned arena — never bigger than the free-run peak —
    #    and with bounded dims the arena size has a compile-time guarantee.
    st = opt_b.last_report.stats
    print(f"memory planner: arena={st.arena_bytes/2**20:.2f} MiB "
          f"(<= peak {st.device_peak/2**20:.2f} MiB) across {st.slots} "
          f"slots, reuse_ratio={st.reuse_ratio:.2f}, "
          f"guaranteed arena <= {opt_b.arena_bound_bytes/2**20:.2f} MiB")
    assert st.arena_bytes <= st.device_peak
    assert st.arena_bytes <= opt_b.arena_bound_bytes
    return {"losses": losses, "loss_free": float(loss_free)}


if __name__ == "__main__":
    main()
