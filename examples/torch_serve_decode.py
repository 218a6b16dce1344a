"""Shape-bucketed serving with a rolled autoregressive decode loop, on the
PyTorch port (the twin of ``examples/serve_decode.py``).

1. compiles a prefill-style step once with symbolic ``(b, s)`` and
   ``buckets=``, so the schedule/remat/arena pipeline specializes per
   sequence-length bucket;
2. warms the buckets the worker expects, then drives mixed-length
   requests through ``BucketBatcher``: same-bucket requests dispatch
   together, and a memory budget holds back buckets whose *guaranteed*
   arena bound does not fit;
3. compiles the decode loop **rolled**: one ``scan`` with a symbolic trip
   count becomes a single ``Loop`` instruction over a lowered body
   sub-program, so plan size, compile time and the steady-state arena do
   not depend on how many tokens a request generates;
4. runs the multi-architecture decode smoke loop (``launch.serve.serve``).

Inputs come from ``np.random.RandomState(0)`` in the reference's order.
Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_decode.py
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""
import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.core import (TensorSpec, optimize, resolve_device, scan,
                              symbolic_dim, symbolic_dims)
from repro_torch.launch.serve import BucketBatcher, serve

D, F_ = 64, 256
VOCAB = 128
ARCHS = ["llama2-1b", "gemma-2b", "deepseek-v3-671b", "xlstm-1.3b",
         "hymba-1.5b"]


def prefill_step(w, x):
    """Attention-flavoured prefill block: activations scale with b*s*s."""
    h = F.gelu(x @ w["wi"], approximate="tanh")
    scores = torch.softmax(h @ h.transpose(-1, -2) / math.sqrt(F_), dim=-1)
    ctx = scores @ h
    return torch.tanh(ctx @ w["wo"]).sum(-1)


def decode_cell(w, h, p):
    """One greedy step: the state update and the sampled token ids."""
    h = torch.tanh(h @ w["wh"] + p)                 # state update
    return h, (h @ w["wv"]).argmax(-1)              # readout -> token


def decode_loop(w, h0, pos):
    """T greedy decode steps as ONE rolled loop: carry = hidden state,
    per-step output = the sampled token ids."""
    return scan(lambda h, p: decode_cell(w, h, p), h0.tanh(), pos)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    f32 = torch.float32

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # -- 1. one trace, per-bucket specialization ------------------------------
    B, S = symbolic_dims("b, s")
    w_specs = {"wi": TensorSpec((D, F_), f32), "wo": TensorSpec((F_, D), f32)}
    fn = optimize(prefill_step, w_specs, TensorSpec((B, S, D), f32),
                  dynamic_dims={"b": (1, 8), "s": (16, 1024)},
                  buckets={"s": [64, 256]}, device=dev)
    table = fn.specialization_table
    print(f"bucket space: {table.space!r}")
    print(f"whole-range guaranteed arena: "
          f"{fn.arena_bound_bytes/2**20:.1f} MiB")

    # -- 2. warmup + bucket-aware batching ------------------------------------
    fn.warmup([{"b": 4, "s": 32}, {"b": 4, "s": 128}])   # expected traffic
    budget = 48 << 20                                    # this worker's slice
    batcher = BucketBatcher(fn, memory_budget=budget)
    rng = np.random.RandomState(0)
    w = {"wi": t(rng.randn(D, F_) * 0.05), "wo": t(rng.randn(F_, D) * 0.05)}
    for s in [24, 900, 48, 200, 60, 128, 980]:           # mixed lengths
        batcher.submit({"b": 2, "s": s}, payload=t(rng.randn(2, s, D)))
    for group in batcher.drain():
        bound = group.arena_bound_bytes
        n_inst = group.n_instructions                    # Program length
        print(f"dispatch {len(group)} reqs in bucket {group.label:24s} "
              f"(arena <= {bound/2**20:5.1f} MiB, "
              f"program={n_inst if n_inst is not None else '?'} instrs)")
        for x in group.payloads:
            fn(w, x)
    st = fn.last_report.stats
    print(f"held over budget: {batcher.pending()} reqs "
          f"{list(batcher.pending_by_bucket())}")
    print(f"dispatch stats: hits={st.bucket_hits} "
          f"specializations={st.specialize_count} "
          f"last dispatch={st.last_dispatch_ns/1e3:.0f} us\n")

    # -- 3. the decode loop itself, rolled ------------------------------------
    T = symbolic_dim("t")                                # symbolic trip count
    dw_specs = {"wh": TensorSpec((D, D), f32),
                "wv": TensorSpec((D, VOCAB), f32)}
    dec = optimize(decode_loop, dw_specs, TensorSpec((4, D), f32),
                   TensorSpec((T, D), f32), dynamic_dims={"t": (1, 512)},
                   buckets={"t": [16, 64]}, device=dev)
    dw = {"wh": t(rng.randn(D, D) * 0.2), "wv": t(rng.randn(D, VOCAB) * 0.2)}
    h0 = t(rng.randn(4, D) * 0.2)
    counts = None
    for gen in [8, 17, 100, 300]:                        # ONE plan, any gen
        pos = t(rng.randn(gen, D) * 0.1)
        _, tokens = dec(dw, h0, pos)
        st = dec.last_report.stats
        counts = dec.program.counts()
        print(f"rolled decode gen={gen:4d}: "
              f"tokens[:6]={tokens[:6, 0].tolist()} "
              f"peak={st.device_peak/1024:.1f}KiB arena={st.arena_bytes} "
              f"program={sum(counts.values())} instrs "
              f"(Loop={counts['Loop']})")
    print("plan is O(body), not O(T*body): "
          f"{sum(counts.values())} instructions serve every gen length\n")

    # -- 4. the multi-architecture decode smoke loop --------------------------
    for arch in ARCHS:
        r = serve(get_smoke_config(arch), batch=4, prompt_len=16, gen=8,
                  device=dev)
        sample = r["tokens"][0][:5].tolist() if r["tokens"] is not None \
            else "-"
        print(f"{arch:18s} prefill {1000*r['prefill_s']:7.1f} ms | "
              f"decode {r['decode_tok_per_s']:8.1f} tok/s | "
              f"sample {sample}")
    return {"loop_counts": counts}


if __name__ == "__main__":
    main()
