"""Ragged batch serving on the PyTorch port: value-dependent bounded dims
end to end (the twin of ``examples/ragged_batch.py``).

A packed-sequence workload: requests arrive as a padded token batch plus
a validity mask, and the model runs its expensive FFN only on the *valid*
rows.  How many rows are valid is decided by the input **values**: no
declared range can know it at compile time.  ``masked_select`` introduces
a fresh bounded dim ``b <= s``: the planner reserves its slots at the cap,
and at run time a ``BindDim`` step publishes the measured extent, so every
later fit, free and peak uses the tight size.  Dispatch buckets on the
*declared* dims; the bounded dim is measured per call inside whichever
bucket serves it.  Inputs come from ``np.random.RandomState(0)`` in the
reference's order.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_ragged_batch.py
    PYTHONPATH=src python examples/torch_ragged_batch.py --device cpu
"""
import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (TensorSpec, optimize, resolve_device,
                              symbolic_dim)
from repro_torch.kernels import masked_select

D, F_ = 32, 128
REQUESTS = [(48, 1.0), (48, 0.25), (300, 0.6), (300, 0.02), (300, 0.0)]


def serve_step(x, mask, w1, w2):
    """Select the valid rows and run the wide FFN on them alone."""
    rows, n_valid = masked_select(x, mask)         # (b, D), b <= s: bounded
    h = F.gelu(rows @ w1, approximate="tanh")      # (b, F): propagated
    y = h @ w2                                     # (b, D)
    return y.sum(0), n_valid


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    f32 = torch.float32

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # 1. The serve step over a padded batch of s rows (declared, bucketed).
    S = symbolic_dim("s")
    specs = (TensorSpec((S, D), f32), TensorSpec((S,), torch.bool),
             TensorSpec((D, F_), f32), TensorSpec((F_, D), f32))

    # 2. Compile once, bucketed on the declared dim.  The bounded dim never
    #    appears in dynamic_dims: the input decides it, per call.
    fn = optimize(serve_step, *specs, dynamic_dims={"s": (1, 512)},
                  buckets="geometric", device=dev)
    (bname, cap), = fn.plan.graph.bound_dims.items()
    print(f"traced: bounded dim {bname} <= {cap} "
          f"(reserve {fn.arena_bound_bytes / 2**10:.0f} KiB at the cap)")

    # 3. Serve a ragged request stream: the same padded size, wildly
    #    different occupancy.  The measured extent is in MemoryStats, and
    #    the peak tracks it, not the pad.
    rng = np.random.RandomState(0)
    w1 = t(rng.randn(D, F_) * 0.05)
    w2 = t(rng.randn(F_, D) * 0.05)
    print(f"{'rows':>5} {'valid':>5} {'bucket':>7} {'measured':>9} "
          f"{'peak KiB':>9} {'arena KiB':>10}")
    counts = []
    for s_rows, occ in REQUESTS:
        x = t(rng.randn(s_rows, D))
        mask = torch.arange(s_rows, device=dev) < int(round(s_rows * occ))
        out, n_valid = fn(x, mask, w1, w2)
        st = fn.last_report.stats
        measured = st.measured_dims[bname]
        assert measured == int(n_valid) == int(round(s_rows * occ))
        assert st.arena_bytes <= fn.arena_bound_bytes
        counts.append((int(n_valid), measured))
        print(f"{s_rows:5d} {int(n_valid):5d} {str(fn.last_bucket):>7} "
              f"{measured:9d} {st.device_peak / 2**10:9.1f} "
              f"{st.arena_bytes / 2**10:10.1f}")

    # 4. The tight accounting is the point: an almost-empty batch peaks
    #    far below a full one of the same padded size.
    peaks = {}
    x = t(rng.randn(300, D))
    for occ in (1.0, 0.02):
        fn(x, torch.arange(300, device=dev) < int(300 * occ), w1, w2)
        peaks[occ] = fn.last_report.stats.device_peak
    print(f"padded 300 rows: full-occupancy peak {peaks[1.0] / 2**10:.0f} "
          f"KiB, 2%-occupancy peak {peaks[0.02] / 2**10:.0f} KiB "
          f"({peaks[0.02] / peaks[1.0]:.2f}x)")
    assert peaks[0.02] < peaks[1.0]

    # 5. And the plan stays honest: the replayed timeline at the measured
    #    env audits clean against the compile-time liveness plan.
    diff = fn.memory_timeline(fn.last_report.env)
    assert diff.ok, diff.summary()
    print(f"plan-vs-actual at the measured env: ok "
          f"({len(diff.actual.points)} instruction points, "
          f"0 unexplained allocations)")
    return {"counts": counts}


if __name__ == "__main__":
    main()
