#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: card name and power limit, TF32 off, kernels built from
   ``src/repro_torch/csrc`` (build seconds, ptxas register/smem report;
   the bf16 flash kernel must not spill);
2. kernels against their plain PyTorch versions at the main path's shapes
   and layout and at the reference kernel tests' shapes, f32 and bf16
   (elementwise rtol = atol and ||got - want|| / ||want|| both within
   2e-4 / 1e-2); flash attention has two routes, bf16 through
   ``flash_attention_sm90.cu`` (TMA + wgmma) and f32 through
   ``flash_attention.cu``; each with kernel, plain and library-call times
   and the card's bound for the same work at every request shape;
3. main path: ``optimize(make_prefill_step(llama2_1b))`` at full width
   (4 layers, bf16, random weights from seed 0), serving four requests of
   different (b, s) through one plan; asserts 4 flash-attention launches,
   all of them on the sm90 route, and 9
   RMSNorm launches per request, device_peak <= guaranteed_peak_bytes,
   the caching allocator's real peak of the request within device_peak
   plus the allocator's block overheads, arena_bytes <= arena_bound_bytes,
   finite logits, a single capture;
   then, outside the counted run, the median wall time per request shape
   and a torch.profiler breakdown of device time by kernel;
4. the same requests through the plain path (``impl="ref"``): logits agree
   to 5e-2;
5. the f32 path: the same model at full width in float32, depth cut to 1
   layer, serving two requests through one plan: 1 launch of the f32
   flash route and 3 RMSNorm launches per request, logits within 2e-4 of
   the plain path;
6. the train path: ``optimize(make_train_step(llama2_1b))`` at full width
   (4 layers, bf16 weights, f32 AdamW moments), forward, backward and
   AdamW captured as one graph and planned once with the parameters and
   moments donated (``call_donated`` on fresh copies of the state, so the
   step's old state is freed inside the step).  Uncapped at (b, s) =
   (1,16), (2,1000), (8,1024): median step time, 4 flash and 9 RMSNorm
   launches per step, device_peak <= guaranteed_peak_bytes, the
   allocator's peak of the step within device_peak plus block overhead,
   finite loss; at (8,1024) loss, updated parameters and moments against
   an eager call of the plain step (``impl="ref"``) within
   TRAIN_PLAIN_TOL.  Then a ladder of memory limits at (8,1024), 0.95, 0.90,
   ... of the uncapped device_peak, down to the first rung that raises
   MemoryLimitExceeded: at each rung device_peak <= limit, the
   allocator's peak of the step <= limit plus block overhead, loss and
   every updated parameter and moment bitwise equal to the uncapped
   step; at least one rung must evict.  Evictions, offloads to pinned host
   memory, recomputes, evicted bytes, host peak, step time and launches
   per step are printed per rung, and for the offloads whether the cost
   model chose them or a victim chosen for recompute fell back to offload
   because a source of its recompute was gone.  At full width every victim
   has been offloaded so far (the ladder exercises offload and reload, not
   recompute; ``tests/test_torch_gpu.py`` recomputes on the card at smoke
   widths).

7. buckets: (a) the same requests through
   ``optimize(make_prefill_step(llama2_1b), buckets="geometric")`` on
   phase 3's weights: 4 x 4 geometric buckets (``b`` edges 2, 3, 5, 8;
   ``s`` edges 45, 128, 362, 1024), each compiled on its first request
   from the whole-range capture; per request its bucket and ranges, the
   bucket's pipeline seconds and reuse of the parent's schedule, its
   ``peak_bound_bytes`` and ``arena_bound_bytes`` beside the whole range's,
   the variant selected per kernel node and ``device_peak``; asserts
   device_peak <= the bucket's guaranteed peak <= the whole range's, the
   allocator within its slack, launches equal to what the selections
   imply, and logits bitwise equal to phase 3's where every selection
   agrees with the whole-range plan's (else within 5e-2 of the plain
   path); then 10 hits per shape, timed in turns with the unbucketed plan
   of the same capture (no compile, no capture; dispatch ns per call).
   (b) the same with ``background_specialize=True``: each first request
   is served by the whole-range fallback, bitwise equal to phase 3, and
   after ``drain_specializations()`` hits its bucket with (a)'s logits.
   (c) a ``BucketBatcher`` whose memory budget lies between the two
   largest bucket arena bounds holds the (8,1024) group and runs the
   others with (a)'s logits.  (d) kernel selection on the kernel-bench
   step (``benchmarks/kernel_bench.py``) at llama2_1b widths, b in [1, 16],
   s in [1, 2048], buckets on s at 64, f32 and bf16: each bucket's
   selections with the model's times, and ``remeasure_kernels`` at (4,32)
   and (4,1024) with every variant's measured time beside the model's.

8. bounded: ``examples/ragged_batch.py``'s serve step (``masked_select``
   -> ``gelu(rows @ w1) @ w2`` -> ``sum``) at llama2_1b widths (D 4096,
   F 11008, bf16, ``s`` in [1, 8192], geometric buckets), one padded
   batch of 8192 rows at occupancy 1.0, 0.75, 0.5, 0.25, 0.02 and 0: the
   measured bounded dim and ``n_valid`` equal the valid rows,
   ``device_peak`` falls with occupancy and stays under the pad-to-bound
   peak (the bucket's Program replayed at the cap), the arena within its
   bound, the caching allocator's peak of the call within ``device_peak``
   plus block overheads and the boolean index's indices (the payload is
   tight on the card), the output within 5e-2 of the eager step
   (``torch.masked_select``); median of 10 calls and the BindDim count
   read in us; a profile at occupancy 1.0 and 0.02;
9. loop: ``examples/serve_decode.py``'s rolled decode loop
   (``h = tanh(h @ wh + p)``, ``argmax(h @ wv)``) at llama2_1b widths (D
   4096, vocab 32000, batch 4, f32), ``t`` in [1, 512] bucketed at 16 and
   64: one ``Loop`` instruction, instruction counts equal under t in
   [1, 64] and [1, 4096], rolled bitwise equal to the unrolled plan at
   T = 1 and 17 (per-step times of both), the hidden state at T = 512
   within 2e-4 of the eager loop, device_peak(512) - device_peak(17)
   equal to the xs and ys bytes, the arena within its bound and the
   allocator within its slack; compile seconds per trip range; a profile
   of the rolled and the unrolled plan at T = 17.
10. obs (``[obs]`` lines): (a) the compile spans of phase 3's prefill,
   phase 6's train step and phase 7's bucketed plan (seconds per phase),
   each exported with ``chrome_trace_json`` to ``build/`` and checked
   (parses; ts, dur, pid, tid on every event; children inside their
   parents); (b) ``memory_timeline(env)`` at every call phases 3, 6, 8
   and 9 observed (the four requests, the uncapped train step at three
   shapes, each bounded occupancy with its measured ``__b0``, the loop at
   T = 1, 17, 512): no drift, replayed peak = predicted = the call's
   ``device_peak``, the allocator's peak within the phase's slack of it;
   (c) inside phase 6, the 0.85 rung's dynamic stream with the VM's
   ``timeline_hook``: the allocator's counter within ``device_used`` +
   slack after every instruction, and the hook's cost per step; (d) the
   disabled telemetry check <= 2% of the (1,16) call, unbucketed and
   bucketed, with interleaved medians (reported only); (e) telemetry on
   the bucketed plan: ring records = the calls' reports, sampled
   timelines, ``wall_s`` (host) beside CUDA-event time, ``kernel-select``
   decisions = the plans' selections, ``BucketBatcher.metrics_text()``
   parses as Prometheus text; (f) the first bucketed call of the run taken
   apart (specialize spans, dispatch, VM host time, device time, garbage
   collections); (g) ``explain(b=8, s=1024)`` of the prefill plan has
   every section heading.  Phase 10 launches kernels after every path's
   launch count has been read.

The line before the last is a JSON object describing each kernel (its
launches per path, each counted from 0 just before the path: prefill,
prefill_f32, train, buckets = phase 7 (a)-(c), bounded, loop; the last
two launch none: their ops are plain PyTorch, as the reference's are
plain jnp); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REQUESTS = [(1, 16), (4, 128), (2, 1000), (8, 1024)]
DYNAMIC_DIMS = {"b": (1, 8), "s": (16, 1024)}
# bf16: one rounding of the output is 2^-8 relative; kernel and plain
# version may round one ulp apart, which 1e-2 covers and a lost kv tile
# does not (f32 at 2e-4 holds the same code to far less)
TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# the most PyTorch's caching allocator may charge beyond a tensor's bytes:
# a block of at most 1 MiB is rounded up to 512 bytes and split off its
# segment only when 512 bytes or more remain; a larger block is split only
# when more than 1 MiB would remain, so it may be up to 1 MiB bigger
SMALL_BLOCK = 1 << 20
SMALL_OVERHEAD, LARGE_OVERHEAD = 1024, SMALL_BLOCK + 512
# published H100 SXM peaks (dense): HBM bytes/s, FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

FLASH_TEST_SHAPES = [  # (b, hq, hkv, s, t, hd): tests/test_kernels.py:17-52
    (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 128, 128),
    (2, 4, 4, 100, 100, 64), (1, 6, 2, 384, 384, 32),
    (3, 2, 1, 64, 64, 64), (1, 4, 2, 100, 160, 64)]
# the bf16 route also at one row and at a ragged 17 rows, model widths
FLASH_BF16_SHAPES = FLASH_TEST_SHAPES + [(1, 32, 32, 1, 1, 128),
                                         (1, 32, 32, 17, 17, 128)]
F32_REQUESTS = [(1, 16), (2, 1000)]
TRAIN_SHAPES = [(1, 16), (2, 1000), (8, 1024)]
TRAIN_REPS = 5
# the kernel path's uncapped train step against the plain step's at
# (8,1024), about 3x what the H100 read (loss 2.8e-5; weights one bf16 ulp
# below 0.25, 9.8e-4; moments' relative error norm 1.3e-2 and 1.6e-2): the
# two attention outputs round apart in bf16, so the gradients differ by
# bf16 noise, and a wrongly saved q/k/v or a lost gradient moves the
# moments by O(1)
TRAIN_PLAIN_TOL = {"loss": 1e-4, "params_max_abs": 2e-3, "m_rel": 5e-2,
                   "v_rel": 5e-2}
CAP_STEP = 0.05     # the ladder's rungs: 0.95, 0.90, ... of the peak
MAX_SUBGRAPH = 24   # optimize's default recompute-subgraph size
RMSNORM_TEST_SHAPES = [(64, 256), (100, 300), (32, 2048), (7, 128),
                       (2, 33, 160)]


# what phase 10 ([obs]) reads from the phases it observes: the functions
# whose compile spans it reports, and per observed call (path, function,
# env, the call's device_peak, the allocator's peak of the call less what
# was held outside it, the allocator slack that phase allows)
OBS = {"timelines": []}


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_bound(b, hq, hkv, s, t, hd, dtype_name, itemsize, causal=True):
    """Least time for the work: each input read once and the output
    written once over HBM, against the causal multiply-adds (2 flops each,
    QK and PV) that this mask needs over the peak rate for the type."""
    nbytes = (2 * b * hq * s * hd + 2 * b * hkv * t * hd) * itemsize
    keys = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    flops = 4 * b * hq * keys * hd
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rmsnorm_bound(n, d, dtype_name, itemsize):
    nbytes = (2 * n * d + d) * itemsize
    flops = 5 * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def allocator_slack(program, env) -> int:
    """The most the caching allocator may hold beyond the plan's bytes at
    one time in a call at ``env``: the largest sum of per-block overheads
    over the values the program holds at once (the step's inputs were
    allocated before the call and are not counted)."""
    from repro_torch.core.lowering.program import OP_COMPUTE, OP_FREE_SLOT
    nbytes = program.resolve(env).nbytes
    live, now, most = {}, 0, 0
    for inst in program.instructions:
        if inst.op == OP_COMPUTE:
            for _oi, r in inst.store:
                live[r] = (LARGE_OVERHEAD if nbytes[r] > SMALL_BLOCK
                           else SMALL_OVERHEAD if nbytes[r] else 0)
                now += live[r]
            most = max(most, now)
        elif inst.op == OP_FREE_SLOT:
            now -= live.pop(inst.reg, 0)
    return most


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels.build import load_library
    lib = load_library()
    log(f"[build] {lib.path.name}: {lib.build_seconds:.2f} s")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")
    sm90 = sm90_ptxas(lib.ptxas_log)
    for hd, regs, spill in sm90:
        log(f"[ptxas] flash_fwd_sm90<{hd}>: {regs} registers, {spill} spill "
            f"bytes")
    if sorted(r[0] for r in sm90) != [32, 64, 128] or any(r[2] for r in sm90):
        raise AssertionError(f"sm90 flash kernel: want hd 32/64/128 without "
                             f"spills, ptxas says {sm90}")
    return name, smi_line


def sm90_ptxas(report: str):
    """(hd, registers, spill bytes) of each instance of the sm90 flash
    kernel in nvcc's ``-Xptxas -v`` report."""
    rows, hd, spill = [], None, 0
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            inst = re.search(r"flash_fwd_sm90ILi(\d+)E", entry.group(1))
            hd, spill = (int(inst.group(1)) if inst else None), 0
            continue
        if hd is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if sp:
            spill = int(sp.group(1)) + int(sp.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            rows.append((hd, int(used.group(1)), spill))
            hd = None
    return rows


def agree(got, want, tol: float, what: str):
    """Elementwise ``assert_close`` at rtol = atol = ``tol`` and the
    relative error norm within ``tol``; returns (max abs err, rel norm)."""
    import torch
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol, msg=lambda m:
                               f"{what}: {m}")
    d = got.float() - want.float()
    rel = (d.norm() / want.float().norm()).item()
    if not rel <= tol:
        raise AssertionError(f"{what}: relative error norm {rel:.3g} > {tol}")
    return d.abs().max().item(), rel


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (flash_attention_cuda, reference_attention,
                                     reference_rmsnorm, rmsnorm_cuda)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                ).to(dtype)

    def flash(q, k, v, causal=True):
        """flash_attention_cuda, asserting the route its dtype must take."""
        n0 = flash_attention_cuda.sm90_launches
        out = flash_attention_cuda(q, k, v, causal=causal)
        if flash_attention_cuda.sm90_launches - n0 != \
                (q.dtype == torch.bfloat16):
            raise AssertionError(f"{q.dtype} flash took the wrong route")
        return out

    # correctness: test shapes in both dtypes, then every main-path shape
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        shapes = FLASH_BF16_SHAPES if dtype == torch.bfloat16 \
            else FLASH_TEST_SHAPES
        for (b, hq, hkv, s, t, hd) in shapes:
            for causal in (True, False):
                q = randn((b, hq, s, hd), dtype)
                k, v = randn((b, hkv, t, hd), dtype), randn((b, hkv, t, hd), dtype)
                agree(flash(q, k, v, causal=causal),
                      reference_attention(q, k, v, causal=causal), tol,
                      f"flash {(b, hq, hkv, s, t, hd)} causal={causal} {dtype}")
        for shape in RMSNORM_TEST_SHAPES:
            x = randn(shape, dtype)
            sc = randn((shape[-1],), dtype, 0.1)
            agree(rmsnorm_cuda(x, sc), reference_rmsnorm(x, sc), tol,
                  f"rmsnorm {shape} {dtype}")
        log(f"[kernels] test shapes agree with the plain versions "
            f"({dtype}, tol {tol})")

    cfg_hq, cfg_hd, cfg_d = 32, 128, 4096
    rows = {}
    for (b, s) in REQUESTS:
        # the main path hands the kernel its (B, S, H, hd) activations
        # transposed; f32 holds the f32 route at 2e-4, bf16 (the served
        # dtype) the sm90 route at 1e-2
        qkv32 = [randn((b, s, cfg_hq, cfg_hd), torch.float32).transpose(1, 2)
                 for _ in range(3)]
        x32 = randn((b * s, cfg_d), torch.float32)
        sc32 = randn((cfg_d,), torch.float32, 0.1)
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v = (t.to(dtype) for t in qkv32)
            f_err, f_rel = agree(flash(q, k, v), reference_attention(q, k, v),
                                 TOL[name], f"flash (b={b}, s={s}) {name}")
            f_ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal=True))
            f_plain = time_ms(lambda: reference_attention(q, k, v, causal=True),
                              reps=5)
            f_lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
            f_bound, f_by = flash_bound(b, cfg_hq, cfg_hq, s, s, cfg_hd, name,
                                        dtype.itemsize)
            route = "sm90" if dtype == torch.bfloat16 else "simt"
            log(f"[kernels] flash/{route} (b={b},h={cfg_hq},s={s},hd={cfg_hd}) "
                f"{name}: max err {f_err:.3g} rel norm {f_rel:.3g} (tol "
                f"{TOL[name]}); kernel {f_ms:.4f} ms plain {f_plain:.4f} ms "
                f"sdpa {f_lib:.4f} ms bound {f_bound:.4f} ms ({f_by}), "
                f"{100 * f_bound / f_ms:.1f}% of bound")
            row[f"flash_{name}"] = dict(err=f_err, ms=f_ms, plain=f_plain,
                                        lib=f_lib, bound=f_bound, by=f_by)
            x, sc = x32.to(dtype), sc32.to(dtype)
            n_err, n_rel = agree(rmsnorm_cuda(x, sc), reference_rmsnorm(x, sc),
                                 TOL[name], f"rmsnorm ({b * s},{cfg_d}) {name}")
            log(f"[kernels] rmsnorm ({b * s},{cfg_d}) {name} vs plain: max err "
                f"{n_err:.3g} rel norm {n_rel:.3g} (tol {TOL[name]})")
        n_ms = time_ms(lambda: rmsnorm_cuda(x, sc))
        n_plain = time_ms(lambda: reference_rmsnorm(x, sc))
        w = 1.0 + sc
        n_lib = time_ms(lambda: F.rms_norm(x, (cfg_d,), w, 1e-6))
        n_bound, n_by = rmsnorm_bound(b * s, cfg_d, "bfloat16", 2)
        log(f"[kernels] rmsnorm ({b * s},{cfg_d}) bf16: err {n_err:.3g} "
            f"kernel {n_ms:.4f} ms plain {n_plain:.4f} ms F.rms_norm "
            f"{n_lib:.4f} ms bound {n_bound:.4f} ms ({n_by})")
        row["rmsnorm"] = dict(err=n_err, ms=n_ms, plain=n_plain, lib=n_lib,
                              bound=n_bound, by=n_by)
        rows[(b, s)] = row
        del q, k, v, x, qkv32, x32
    torch.cuda.empty_cache()
    return rows


def _requests(cfg, gen):
    import torch
    return [{"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32)}
            for (b, s) in REQUESTS]


def phase_main_path():
    import torch
    from torch.utils import _pytree as pytree

    import repro_torch.core.api as api
    from repro_torch.configs.llama2_1b import CONFIG
    from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
    from repro_torch.kernels import flash_attention_cuda, rmsnorm_cuda
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = CONFIG
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[main] llama2_1b params {cfg.param_count() / 1e9:.3f} B "
        f"({cfg.dtype}) init {time.perf_counter() - t0:.2f} s")

    captures = []
    real_capture = api.capture

    def counted_capture(*a, **kw):
        captures.append(1)
        return real_capture(*a, **kw)

    api.capture = counted_capture
    try:
        B, S = symbolic_dims("b, s")
        specs = (spec_like(params), {"tokens": TensorSpec((B, S), torch.int32)})
        t0 = time.perf_counter()
        opt = optimize(make_prefill_step(cfg), *specs,
                       dynamic_dims=DYNAMIC_DIMS)
        # kernel_select=False: selection would override impl="ref" and
        # the plain side would launch the kernels it is held against
        opt_ref = optimize(make_prefill_step(cfg, impl="ref"), *specs,
                           dynamic_dims=DYNAMIC_DIMS, kernel_select=False)
        log(f"[main] optimize x2 {time.perf_counter() - t0:.2f} s, "
            f"graph {opt.plan.graph.stats()}, guards {opt.report.guards}, "
            f"program {opt.program.counts()}")
    finally:
        api.capture = real_capture
    log(f"[main] guaranteed_peak_bytes {opt.guaranteed_peak_bytes} "
        f"arena_bound_bytes {opt.arena_bound_bytes}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batches = _requests(cfg, gen)
    # warm up cuBLAS and the kernel library outside the measured run
    opt(params, batches[0])
    torch.cuda.synchronize()
    n_captures = len(captures)

    # the plan counts the step's inputs (weights and tokens) and what the
    # step allocates; the allocator also holds what lives outside the step
    # (cuBLAS workspace, earlier requests' logits and tokens), and charges
    # its block overheads (allocator_slack)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params))
    flash_attention_cuda.launches = 0
    flash_attention_cuda.sm90_launches = 0
    rmsnorm_cuda.launches = 0
    outs, rows = [], []
    for (b, s), batch in zip(REQUESTS, batches):
        f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
        g0 = flash_attention_cuda.sm90_launches
        tokens = batch["tokens"]
        held = torch.cuda.memory_allocated() - param_bytes - \
            tokens.numel() * tokens.element_size()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits = opt(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = opt.last_report.stats
        peak_alloc = torch.cuda.max_memory_allocated()
        step_alloc = peak_alloc - held
        slack = allocator_slack(opt.program, {"b": b, "s": s})
        fl = flash_attention_cuda.launches - f0
        gl = flash_attention_cuda.sm90_launches - g0
        nl = rmsnorm_cuda.launches - n0
        token = logits.float().argmax(-1).tolist()
        log(f"[main] request b={b} s={s}: wall {1e3 * wall:.3f} ms "
            f"next_token {token[:4]} device_peak {st.device_peak} "
            f"guaranteed_peak_bytes {opt.guaranteed_peak_bytes} "
            f"arena_bytes {st.arena_bytes} arena_bound_bytes "
            f"{opt.arena_bound_bytes} max_memory_allocated {peak_alloc} "
            f"held outside the step {held} allocator peak of the step "
            f"{step_alloc} (device_peak + {step_alloc - st.device_peak}; "
            f"block-overhead slack {slack}) launches flash {fl} (sm90 {gl}) "
            f"rmsnorm {nl}")
        if tuple(logits.shape) != (b, cfg.vocab):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits.float()).all():
            raise AssertionError("non-finite logits")
        if fl != cfg.n_layers or gl != cfg.n_layers or \
                nl != 2 * cfg.n_layers + 1:
            raise AssertionError(f"launches flash {fl} (sm90 {gl}) rmsnorm "
                                 f"{nl} per request")
        if st.device_peak > opt.guaranteed_peak_bytes:
            raise AssertionError("device_peak above guaranteed_peak_bytes")
        # device_peak <= guaranteed_peak_bytes, so this also holds the
        # allocator to the guarantee
        if step_alloc > st.device_peak + slack:
            raise AssertionError(
                f"the allocator's peak of the request, {step_alloc}, is above "
                f"device_peak + {slack} of block overhead")
        if st.arena_bytes > opt.arena_bound_bytes:
            raise AssertionError("arena_bytes above arena_bound_bytes")
        OBS["timelines"].append(("prefill", opt, {"b": b, "s": s},
                                 st.device_peak, step_alloc, slack))
        outs.append(logits)
        rows.append(dict(b=b, s=s, wall_ms=1e3 * wall,
                         device_peak=st.device_peak,
                         arena_bytes=st.arena_bytes,
                         max_memory_allocated=peak_alloc,
                         step_alloc_peak=step_alloc, alloc_slack=slack))
    launches = {"flash_attention": flash_attention_cuda.launches,
                "flash_attention_sm90": flash_attention_cuda.sm90_launches,
                "rmsnorm": rmsnorm_cuda.launches}
    if len(captures) != n_captures:
        raise AssertionError("the main path re-captured between requests")
    log(f"[main] one capture per optimize ({len(captures)} for 2 plans); "
        f"launches over the run {launches}")
    OBS["prefill"] = opt
    medians = phase_latency(opt, params, batches)
    phase_profile(opt, params, batches)
    return cfg, params, opt_ref, batches, outs, launches, rows, medians


def phase_latency(opt, params, batches, reps: int = 10):
    """Median and max wall time per request shape over ``reps`` calls,
    each ending in ``synchronize()`` (after the counted run)."""
    import statistics

    import torch
    medians = {}
    for (b, s), batch in zip(REQUESTS, batches):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            opt(params, batch)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        log(f"[latency] b={b} s={s}: median {statistics.median(walls):.3f} ms "
            f"min {min(walls):.3f} max {max(walls):.3f} over {reps} calls; "
            f"{b * s / statistics.median(walls) * 1e3:.0f} prompt tokens/s")
        medians[(b, s)] = statistics.median(walls)
    return medians


def phase_profile(opt, params, batches):
    """Device time by kernel over one request at the smallest and largest
    shapes.  Runs after the main path's launch counts are read."""
    for (b, s), batch in ((REQUESTS[0], batches[0]),
                          (REQUESTS[-1], batches[-1])):
        profile_once(f"b={b} s={s}", lambda: opt(params, batch))


def profile_once(label: str, run) -> None:
    """torch.profiler over one call of ``run``: device time by kernel and
    the share of the call's wall time with a kernel running."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side kernel rows only: CPU op rows (aten::mm ...) repeat
    # the time of the kernels they launched
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"[profile] {label}: no device time recorded "
            f"(device busy share not measured)")
        return
    log(f"[profile] {label}: wall {wall_us:.0f} us, kernel time "
        f"{busy:.0f} us, device busy share {busy / wall_us:.3f}")
    for us, count, key in rows[:10]:
        log(f"[profile]   {us:10.1f} us {100 * us / busy:5.1f}% "
            f"x{count:<4d} {key[:90]}")


@contextlib.contextmanager
def gc_pauses():
    """Yields a list that collects (generation, seconds) of every garbage
    collection that runs inside the block."""
    pauses, t0 = [], [0.0]

    def cb(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - t0[0]))

    gc.callbacks.append(cb)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(cb)


def phase_plain(cfg, params, opt_ref, batches, outs):
    import torch
    from repro_torch.launch.steps import make_prefill_step
    step = make_prefill_step(cfg)
    refs = []
    for (b, s), batch, got in zip(REQUESTS, batches, outs):
        ref = opt_ref(params, batch)
        refs.append(ref)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        eager = step(params, batch)
        torch.cuda.synchronize()
        log(f"[plain] b={b} s={s}: max |kernel path - plain path| {err:.4g}; "
            f"VM output bitwise equal to eager step: "
            f"{bool(torch.equal(got, eager))}")
        torch.testing.assert_close(got.float(), ref.float(), rtol=5e-2,
                                   atol=5e-2)
    return refs


def phase_f32_path():
    """The f32 flash route inside the model: llama2_1b at full width in
    float32, depth cut to 1 layer, two requests through one plan, held
    against the plain path at 2e-4.  Returns the f32 route's launches."""
    import dataclasses

    import torch

    from repro_torch.configs.llama2_1b import CONFIG
    from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
    from repro_torch.kernels import flash_attention_cuda, rmsnorm_cuda
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = dataclasses.replace(CONFIG, n_layers=1, dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    B, S = symbolic_dims("b, s")
    specs = (spec_like(params), {"tokens": TensorSpec((B, S), torch.int32)})
    opt = optimize(make_prefill_step(cfg), *specs, dynamic_dims=DYNAMIC_DIMS)
    opt_ref = optimize(make_prefill_step(cfg, impl="ref"), *specs,
                       dynamic_dims=DYNAMIC_DIMS, kernel_select=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                        device="cuda", dtype=torch.int32)}
               for (b, s) in F32_REQUESTS]
    flash_attention_cuda.launches = 0
    flash_attention_cuda.sm90_launches = 0
    rmsnorm_cuda.launches = 0
    outs = [opt(params, batch) for batch in batches]
    torch.cuda.synchronize()
    simt = flash_attention_cuda.launches - flash_attention_cuda.sm90_launches
    n = len(F32_REQUESTS)
    if simt != n * cfg.n_layers or flash_attention_cuda.sm90_launches or \
            rmsnorm_cuda.launches != n * (2 * cfg.n_layers + 1):
        raise AssertionError(
            f"f32 path launches: flash f32 {simt}, sm90 "
            f"{flash_attention_cuda.sm90_launches}, rmsnorm "
            f"{rmsnorm_cuda.launches} over {n} requests")
    for (b, s), batch, got in zip(F32_REQUESTS, batches, outs):
        ref = opt_ref(params, batch)
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
        log(f"[f32] b={b} s={s}: logits {tuple(got.shape)} max |kernel path "
            f"- plain path| {err:.3g} (tol 2e-4)")
    log(f"[f32] launches over {n} requests: flash f32 {simt}, rmsnorm "
        f"{rmsnorm_cuda.launches}")
    del params, opt, opt_ref, outs
    torch.cuda.empty_cache()
    return simt


def phase_train():
    """The train path (phase 6).  Returns the kernels' launches over it."""
    import statistics

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs.llama2_1b import CONFIG
    from repro_torch.core import (MemoryLimitExceeded, TensorSpec, optimize,
                                  spec_like, symbolic_dims)
    from repro_torch.core.scheduling.memsim import simulate_peak_bound
    from repro_torch.kernels import flash_attention_cuda, rmsnorm_cuda
    from repro_torch.launch.steps import adamw_config_for, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    cfg = CONFIG
    params = init_params(cfg, seed=0, device="cuda")
    opt_state = init_state(params, adamw_config_for(cfg))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves((params, opt_state)))
    B, S = symbolic_dims("b, s")
    batch_spec = {"tokens": TensorSpec((B, S), torch.int32),
                  "labels": TensorSpec((B, S), torch.int32)}
    t0 = time.perf_counter()
    opt = optimize(make_train_step(cfg), spec_like(params),
                   spec_like(opt_state), batch_spec,
                   dynamic_dims=DYNAMIC_DIMS, donate_inputs=True)
    compile_s = time.perf_counter() - t0
    plan, rep = opt.plan, opt.report
    undonated = simulate_peak_bound(plan.graph, plan.order, plan.shape_graph,
                                    donate_inputs=False)[1]
    log(f"[train] optimize {compile_s:.2f} s, graph {plan.graph.stats()}, "
        f"guards {rep.guards}, remat candidates {rep.n_candidates} "
        f"(recomputable {rep.n_recomputable}, regen method fixed by bounds "
        f"{rep.n_static_regen}); state {state_bytes} B; "
        f"guaranteed_peak_bytes {opt.guaranteed_peak_bytes} (without "
        f"donation the same order would need {undonated})")
    if rep.guards:
        raise AssertionError(f"the train capture left guards {rep.guards}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    batches = {shape: {k: torch.randint(0, cfg.vocab, shape, generator=gen,
                                        device="cuda", dtype=torch.int32)
                       for k in ("tokens", "labels")}
               for shape in TRAIN_SHAPES}

    def step(fn, batch):
        """One donated call on fresh copies of the state: outputs, stats,
        wall ms, and the allocator's peak of the step (its peak less what
        was held outside the step, the step's inputs excepted)."""
        args = [pytree.tree_map(torch.clone, params),
                pytree.tree_map(torch.clone, opt_state), batch]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - state_bytes - sum(
            t.numel() * t.element_size() for t in batch.values())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn.call_donated(args)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        return (out, fn.last_report.stats, wall,
                torch.cuda.max_memory_allocated() - held)

    def launches():
        return flash_attention_cuda.sm90_launches, rmsnorm_cuda.launches

    def check_step(out, b, s):
        loss, new_params, new_opt = out
        if not torch.isfinite(loss):
            raise AssertionError(f"non-finite loss at ({b},{s})")
        if int(new_opt.step) != 1 or tuple(new_params["embed"].shape) != \
                tuple(params["embed"].shape):
            raise AssertionError("train step returned the wrong state")

    flash_attention_cuda.launches = 0
    flash_attention_cuda.sm90_launches = 0
    rmsnorm_cuda.launches = 0
    want, rows = None, {"uncapped": [], "ladder": []}
    for (b, s) in TRAIN_SHAPES:
        batch, env = batches[(b, s)], {"b": b, "s": s}
        step(opt, batch)                      # warm-up, outside the timing
        slack = allocator_slack(opt.program, env)
        walls = []
        for _ in range(TRAIN_REPS):
            f0, n0 = launches()
            out, st, wall, alloc = step(opt, batch)
            fl, nl = launches()[0] - f0, launches()[1] - n0
            walls.append(wall)
            check_step(out, b, s)
            if (fl, nl) != (cfg.n_layers, 2 * cfg.n_layers + 1):
                raise AssertionError(f"train step launches flash {fl} "
                                     f"rmsnorm {nl}")
            if st.device_peak > opt.guaranteed_peak_bytes:
                raise AssertionError("device_peak above guaranteed_peak")
            if alloc > st.device_peak + slack:
                raise AssertionError(
                    f"the allocator's peak of the step, {alloc}, is above "
                    f"device_peak {st.device_peak} + {slack} of overhead")
        loss = out[0].item()
        row = dict(b=b, s=s, median_ms=statistics.median(walls),
                   min_ms=min(walls), max_ms=max(walls), loss=loss,
                   device_peak=st.device_peak, alloc_peak=alloc,
                   alloc_slack=slack, flash=fl, rmsnorm=nl)
        rows["uncapped"].append(row)
        OBS["timelines"].append(("train", opt, env, st.device_peak, alloc,
                                 slack))
        log(f"[train] ({b},{s}) uncapped: median {row['median_ms']:.3f} ms "
            f"(min {min(walls):.3f}, max {max(walls):.3f}) over "
            f"{TRAIN_REPS} steps, loss {loss:.6f}, device_peak "
            f"{st.device_peak}, allocator peak of the step {alloc} "
            f"(device_peak + {alloc - st.device_peak}; slack {slack}), "
            f"launches per step flash {fl} rmsnorm {nl}, "
            f"{b * s / row['median_ms'] * 1e3:.0f} tokens/s")
        if (b, s) == TRAIN_SHAPES[-1]:
            want, peak = out, st.device_peak
        del out
    profile_once(f"train ({b},{s}) uncapped",
                 lambda: step(opt, batches[TRAIN_SHAPES[-1]]))

    b, s = TRAIN_SHAPES[-1]
    batch, env = batches[(b, s)], {"b": b, "s": s}
    want_leaves = pytree.tree_leaves(want)
    frac, last = 1.0 - CAP_STEP, None
    while frac > CAP_STEP / 2:
        cap = int(frac * peak)
        fn = opt.with_memory_limit(cap)
        slack = allocator_slack(fn.program, env) + \
            MAX_SUBGRAPH * LARGE_OVERHEAD    # a recompute's temporaries
        f0, n0 = launches()
        try:
            out, st, wall1, alloc = step(fn, batch)
        except MemoryLimitExceeded as e:
            log(f"[train] cap {frac:.2f} x peak = {cap}: "
                f"MemoryLimitExceeded ({e}); the ladder ends here")
            break
        fl, nl = launches()[0] - f0, launches()[1] - n0
        equal = len(want_leaves) == len(pytree.tree_leaves(out)) and all(
            torch.equal(x, y)
            for x, y in zip(pytree.tree_leaves(out), want_leaves))
        del out
        _, _, wall2, _ = step(fn, batch)      # pinned host blocks cached
        row = dict(frac=frac, cap=cap, first_ms=wall1, ms=wall2,
                   device_peak=st.device_peak, alloc_peak=alloc,
                   alloc_slack=slack, evictions=st.evictions,
                   offloads=st.offloads, reloads=st.reloads,
                   recomputes=st.recomputes,
                   recompute_fallbacks=st.recompute_fallbacks,
                   evicted_bytes=st.evicted_bytes,
                   host_peak=st.host_peak,
                   recompute_flops=st.recompute_flops, flash=fl, rmsnorm=nl,
                   bitwise_equal=equal)
        rows["ladder"].append(row)
        log(f"[train] cap {frac:.2f} x peak = {cap}: step {wall2:.3f} ms "
            f"(first call {wall1:.3f} ms), device_peak {st.device_peak}, "
            f"allocator peak of the step {alloc} (cap + {alloc - cap}; "
            f"slack {slack}), evictions {st.evictions} (offloads "
            f"{st.offloads}, reloads {st.reloads}, recomputes "
            f"{st.recomputes}; offloaded by the cost model "
            f"{st.offloads - st.recompute_fallbacks}, chosen for recompute "
            f"but offloaded as a source was gone {st.recompute_fallbacks}), "
            f"evicted {st.evicted_bytes} B, host peak "
            f"{st.host_peak} B, recompute flops {st.recompute_flops}, "
            f"launches per step flash {fl} rmsnorm {nl}, outputs bitwise "
            f"equal to the uncapped step: {equal}")
        if st.device_peak > cap:
            raise AssertionError(f"device_peak {st.device_peak} above the "
                                 f"limit {cap}")
        if alloc > cap + slack:
            raise AssertionError(f"the allocator's peak of the step, {alloc},"
                                 f" is above the limit {cap} + {slack}")
        if not equal:
            raise AssertionError(f"capped step at {frac:.2f} differs from "
                                 f"the uncapped step")
        last = fn
        frac = round(frac - CAP_STEP, 2)
    if not any(r["evictions"] for r in rows["ladder"]):
        raise AssertionError("no rung of the cap ladder evicted")
    counts = {"flash_attention_sm90": flash_attention_cuda.sm90_launches,
              "flash_attention_f32": flash_attention_cuda.launches -
              flash_attention_cuda.sm90_launches,
              "rmsnorm": rmsnorm_cuda.launches}
    log(f"[train] launches over the train path {counts}; rows "
        f"{json.dumps(rows)}")
    if counts["flash_attention_f32"]:
        raise AssertionError("the bf16 train path took the f32 flash route")
    profile_once(f"train ({b},{s}) at cap {rows['ladder'][-1]['frac']:.2f}",
                 lambda: step(last, batch))
    observe_dynamic_stream(opt, step, params, opt_state, batch, state_bytes,
                           int(OBS_RUNG * peak), want[0])
    OBS["train"] = opt
    compare_train_plain(cfg, params, opt_state, batch, want)
    del params, opt_state, want, want_leaves, opt, fn, last
    torch.cuda.empty_cache()
    return counts


def compare_train_plain(cfg, params, opt_state, batch, want):
    """The kernel path's uncapped train step (``want``) against an eager
    call of the plain step (``impl="ref"``) on the same state and batch:
    loss, the updated parameters and the moments, within TRAIN_PLAIN_TOL."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.launch.steps import make_train_step
    ref = make_train_step(cfg, impl="ref")(params, opt_state, batch)
    torch.cuda.synchronize()
    loss, new_params, new_opt = want
    r_loss, r_params, r_opt = ref

    def rel_norm(pairs):
        num = den = 0.0
        for got, exp in pairs:
            num += (got.float() - exp.float()).square().sum().item()
            den += exp.float().square().sum().item()
        return (num / den) ** 0.5

    err = {
        "loss": abs(loss.item() - r_loss.item()),
        "params_max_abs": max(
            (x.float() - y.float()).abs().max().item() for x, y in
            zip(pytree.tree_leaves(new_params), pytree.tree_leaves(r_params))),
        "m_rel": rel_norm(zip(pytree.tree_leaves(new_opt.m),
                              pytree.tree_leaves(r_opt.m))),
        "v_rel": rel_norm(zip(pytree.tree_leaves(new_opt.v),
                              pytree.tree_leaves(r_opt.v))),
    }
    b, s = batch["tokens"].shape
    log(f"[train] ({b},{s}) kernel path vs plain step: loss "
        f"{loss.item():.6f} vs {r_loss.item():.6f}; "
        + ", ".join(f"{k} {v:.4g} (tol {TRAIN_PLAIN_TOL[k]})"
                    for k, v in err.items()))
    bad = {k: v for k, v in err.items() if not v <= TRAIN_PLAIN_TOL[k]}
    if bad or int(r_opt.step) != int(new_opt.step):
        raise AssertionError(f"train step differs from the plain step: {bad}")
    del ref, r_params, r_opt
    torch.cuda.empty_cache()


OBS_RUNG = 0.85    # phase 10 (c): the ladder rung whose dynamic stream is read


def observe_dynamic_stream(opt, step, params, opt_state, batch, state_bytes,
                           cap, want_loss):
    """Phase 10 (c), run inside phase 6 after its launch counts are read:
    the train step at (8,1024) under ``cap`` (the 0.85 rung) with the VM's
    ``timeline_hook`` attached.  After every instruction of the dynamic
    stream the hook reads the plan's ``device_used`` and the caching
    allocator's host-side counter (``memory_allocated()``'s: no sync) less
    what was held outside the step and the inputs not yet bound; the
    allocator must stay within ``device_used`` + the slack of a step under
    a limit at every instruction.  Also the hook's cost per step, between
    two steps of the same rung without it."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.core.lowering.program import BindArg

    b, s = batch["tokens"].shape
    env = {"b": b, "s": s}
    fn = opt.with_memory_limit(cap)
    prog = fn.program
    slack = allocator_slack(prog, env) + MAX_SUBGRAPH * LARGE_OVERHEAD
    nbytes = prog.resolve(env).nbytes
    arg_bytes = {inst.reg: nbytes[inst.reg] for inst in prog.instructions
                 if isinstance(inst, BindArg) and inst.index >= 0}
    batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
    pending = [sum(arg_bytes.values())]       # inputs not bound yet
    rows = []
    # memory_allocated()'s own counter, read without memory_stats()'s
    # Python flattening of every other statistic (~100 us a call)
    stats, dev = torch._C._cuda_memoryStats, torch.cuda.current_device()

    def allocated():
        return stats(dev)["allocated_bytes"]["all"]["current"]

    if allocated() != torch.cuda.memory_allocated():
        raise AssertionError("the allocator counter differs from "
                             "memory_allocated()")

    def hook(idx, inst, mm):
        if isinstance(inst, BindArg):
            pending[0] -= arg_bytes.get(inst.reg, 0)
        rows.append((idx, mm.stats.device_used, allocated() - pending[0]))

    walls = {"without": [], "with": []}
    walls["without"].append(step(fn, batch)[2])
    args = [pytree.tree_map(torch.clone, params),
            pytree.tree_map(torch.clone, opt_state), batch]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - state_bytes - batch_bytes
    fn.interp.timeline_hook = hook
    try:
        t0 = time.perf_counter()
        out = fn.call_donated(args)
        torch.cuda.synchronize()
        walls["with"].append(1e3 * (time.perf_counter() - t0))
    finally:
        fn.interp.timeline_hook = None
    st = fn.last_report.stats
    same_loss = torch.equal(out[0], want_loss)
    del out
    walls["without"].append(step(fn, batch)[2])
    gaps = [(alloc - held - used, idx) for idx, used, alloc in rows]
    up, up_idx = max(gaps)
    down, down_idx = min(gaps)

    def name(idx):
        return type(prog.instructions[idx]).__name__

    without = sum(walls["without"]) / len(walls["without"])
    log(f"[obs] (c) train ({b},{s}) at cap {OBS_RUNG} x peak = {cap}: "
        f"dynamic stream, {len(rows)} instructions hooked of "
        f"{len(prog.instructions)}, evictions {st.evictions}, device_peak "
        f"{st.device_peak}; allocator - device_used per instruction: most "
        f"above {up} at #{up_idx} {name(up_idx)}, most below {-down} at "
        f"#{down_idx} {name(down_idx)} (slack {slack}); step with the hook "
        f"{walls['with'][0]:.3f} ms, without {walls['without'][0]:.3f} / "
        f"{walls['without'][1]:.3f} ms: hook cost "
        f"{walls['with'][0] - without:.3f} ms per step "
        f"({1e3 * (walls['with'][0] - without) / len(rows):.2f} us per "
        f"instruction); loss bitwise equal to the uncapped step: "
        f"{same_loss}")
    if len(rows) != len(prog.instructions) or not st.evictions:
        raise AssertionError("the hook did not see a dynamic stream")
    if up > slack:
        raise AssertionError(
            f"at #{up_idx} {name(up_idx)} the allocator holds {up} B above "
            f"the plan's device_used (slack {slack})")
    if not same_loss:
        raise AssertionError("the hooked step changed the loss")
    OBS["dynamic"] = dict(cap=cap, n=len(rows), evictions=st.evictions,
                          above=up, above_at=[up_idx, name(up_idx)],
                          below=-down, below_at=[down_idx, name(down_idx)],
                          slack=slack, with_ms=walls["with"][0],
                          without_ms=walls["without"])


# -- phase 7: bucketed dispatch and per-bucket kernel selection --------------

GEOMETRIC_EDGES = {"b": (2, 3, 5, 8), "s": (45, 128, 362, 1024)}
KB_RANGES = {"b": (1, 16), "s": (1, 2048)}   # benchmarks/kernel_bench.py
KB_EDGES = {"s": [64]}
KB_ENVS = [{"b": 4, "s": 32}, {"b": 4, "s": 1024}]
KB_REPEATS = 10
# what each kernel variant launches, by the launch counter it moves
VARIANT_COUNTER = {"sm90_bm128_bn128": "sm90", "simt_f32_bq64_bkv32": "f32",
                   "cuda_row256": "rmsnorm"}


def _launch_counts():
    from repro_torch.kernels import flash_attention_cuda, rmsnorm_cuda
    return {"sm90": flash_attention_cuda.sm90_launches,
            "f32": flash_attention_cuda.launches
            - flash_attention_cuda.sm90_launches,
            "rmsnorm": rmsnorm_cuda.launches}


def _expected_launches(plan):
    """Launches per call that a plan's kernel selections imply."""
    want = {"sm90": 0, "f32": 0, "rmsnorm": 0}
    for sel in plan.kernel_selections.values():
        counter = VARIANT_COUNTER.get(sel.variant.name)
        if counter is not None:
            want[counter] += 1
    return want


def _selection_summary(plan):
    """variant name -> number of kernel nodes that selected it."""
    out = {}
    for sel in plan.kernel_selections.values():
        out[sel.variant.name] = out.get(sel.variant.name, 0) + 1
    return out


def phase_buckets(cfg, batches, outs, plain, medians):
    """Phase 7 (a)-(c): the llama2_1b prefill through a bucketed plan, the
    same with background specialization, and the BucketBatcher, on phase
    3's weights (made again from seed 0) and requests.  Returns the
    kernels' launches over the three."""
    import statistics

    import torch
    from torch.utils import _pytree as pytree

    import repro_torch.core.api as api
    from repro_torch.core import (DynamicShapeFunction, TensorSpec, optimize,
                                  spec_like, symbolic_dims)
    from repro_torch.kernels import flash_attention_cuda, rmsnorm_cuda
    from repro_torch.kernels.hw_model import HardwareModel
    from repro_torch.launch.serve import BucketBatcher
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    params = init_params(cfg, seed=0, device="cuda")
    captures = []
    real_capture = api.capture

    def counted_capture(*a, **kw):
        captures.append(1)
        return real_capture(*a, **kw)

    B, S = symbolic_dims("b, s")
    specs = (spec_like(params), {"tokens": TensorSpec((B, S), torch.int32)})
    api.capture = counted_capture
    try:
        t0 = time.perf_counter()
        opt = optimize(make_prefill_step(cfg), *specs,
                       dynamic_dims=DYNAMIC_DIMS, buckets="geometric")
        log(f"[buckets] optimize(buckets='geometric') "
            f"{time.perf_counter() - t0:.2f} s (whole-range pipeline "
            f"{opt.report.compile_s:.2f} s); {opt.report.buckets}")
    finally:
        api.capture = real_capture
    table = opt.specialization_table
    edges = {d.name: tuple(d.uppers) for d in table.space.dims}
    if edges != GEOMETRIC_EDGES:
        raise AssertionError(f"geometric bucket edges {edges}")
    hw = HardwareModel.from_device("cuda")
    whole = opt.plan
    log(f"[buckets] cost model of the card {hw}")
    log(f"[buckets] whole range: guaranteed_peak_bytes "
        f"{opt.guaranteed_peak_bytes} arena_bound_bytes "
        f"{opt.arena_bound_bytes} selections {_selection_summary(whole)}")
    whole_sel = {nid: s.variant.name
                 for nid, s in whole.kernel_selections.items()}
    param_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params))
    for name in ("launches", "sm90_launches"):
        setattr(flash_attention_cuda, name, 0)
    rmsnorm_cuda.launches = 0

    # (a) serve REQUESTS once through the bucketed plan
    got_a, rows = [], []
    for i, ((b, s), batch) in enumerate(zip(REQUESTS, batches)):
        env = {"b": b, "s": s}
        tokens = batch["tokens"]
        held = torch.cuda.memory_allocated() - param_bytes - \
            tokens.numel() * tokens.element_size()
        c0 = _launch_counts()
        torch.cuda.reset_peak_memory_stats()
        # phase 10 (f): the first bucketed call of the run, taken apart
        # (GC pauses inside it, device time by CUDA events)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with gc_pauses() as pauses:
            t0 = time.perf_counter()
            ev[0].record()
            logits = opt(params, batch)
            ev[1].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if i == 0:
            OBS["first_call"] = dict(
                env=env, wall_s=wall, gc=pauses,
                device_ms=ev[0].elapsed_time(ev[1]),
                dispatch_ns=opt.last_report.stats.last_dispatch_ns,
                run_s=opt.last_report.wall_s)
        st = opt.last_report.stats
        step_alloc = torch.cuda.max_memory_allocated() - held
        key = opt.last_bucket
        bp = table.peek(key)
        rep = bp.report
        got = {k: v - c0[k] for k, v in _launch_counts().items()}
        want = _expected_launches(bp.plan)
        sel = {nid: s.variant.name
               for nid, s in bp.plan.kernel_selections.items()}
        # the plain variants allocate transients the plan does not count,
        # at most max_transient_bytes (their validity rule) in one op
        transient = hw.max_transient_bytes if any(
            v.startswith("ref") for v in sel.values()) else 0
        slack = allocator_slack(bp.program, env) + transient
        same = sel == whole_sel
        if same:
            equal = torch.equal(logits, outs[i])
            err = (logits.float() - outs[i].float()).abs().max().item()
        else:
            equal = False
            err = (logits.float() - plain[i].float()).abs().max().item()
        log(f"[buckets] (a) b={b} s={s}: bucket {key} "
            f"{table.space.describe(key)}; first call {1e3 * wall:.3f} ms "
            f"(bucket pipeline {rep.compile_s:.3f} s, reused the parent's "
            f"schedule {rep.reused_parent_schedule}, its post-pass "
            f"{rep.reused_parent_postpass}); peak_bound_bytes "
            f"{rep.peak_bound_bytes} (whole range "
            f"{opt.guaranteed_peak_bytes}) arena_bound_bytes "
            f"{rep.arena_bound_bytes} (whole range {opt.arena_bound_bytes}, "
            f"below it: {rep.arena_bound_bytes <= opt.arena_bound_bytes}); "
            f"selections per kernel node {sel}; device_peak "
            f"{st.device_peak} arena_bytes {st.arena_bytes}; allocator peak "
            f"of the request {step_alloc} (device_peak + "
            f"{step_alloc - st.device_peak}; slack {slack}); launches {got} "
            f"(selections imply {want}); logits "
            + (f"bitwise equal to phase 3's: {equal}" if same else
               f"max |bucketed - plain path| {err:.4g} (selections differ "
               f"from the whole-range plan's)"))
        if not st.device_peak <= rep.peak_bound_bytes <= \
                opt.guaranteed_peak_bytes:
            raise AssertionError("bucket guarantee out of order")
        # a bucket that re-schedules may pack its arena less tightly than
        # the whole range did: its own bound holds, and is printed beside
        # the whole range's, but need not be below it
        if st.arena_bytes > rep.arena_bound_bytes:
            raise AssertionError("arena_bytes above the bucket's bound")
        if step_alloc > st.device_peak + slack:
            raise AssertionError(f"allocator peak {step_alloc} above "
                                 f"device_peak + {slack}")
        if got != want:
            raise AssertionError(f"launches {got}, selections imply {want}")
        if same and not equal:
            raise AssertionError("bucketed logits differ from phase 3's")
        if not same:
            torch.testing.assert_close(logits.float(), plain[i].float(),
                                       rtol=5e-2, atol=5e-2)
        got_a.append(logits)
        rows.append(dict(b=b, s=s, key=list(key),
                         ranges=table.space.describe(key),
                         compile_s=rep.compile_s, first_call_ms=1e3 * wall,
                         reused_schedule=rep.reused_parent_schedule,
                         reused_postpass=rep.reused_parent_postpass,
                         peak_bound_bytes=rep.peak_bound_bytes,
                         arena_bound_bytes=rep.arena_bound_bytes,
                         device_peak=st.device_peak,
                         alloc_peak=step_alloc, alloc_slack=slack,
                         selections=_selection_summary(bp.plan)))

    # the second pass: hits only, no compile, no capture; timed in turns
    # with the whole-range plan of the same capture (unbucketed), bucketed
    # first in even rounds and second in odd ones
    whole_fn = DynamicShapeFunction(opt.plan, opt.report, device=opt.device)
    n_spec, n_cap = table.specialize_count, len(captures)
    for (b, s), batch, want_out in zip(REQUESTS, batches, got_a):
        walls = {"bucketed": [], "unbucketed": []}
        ns = []
        whole_fn(params, batch)
        for r in range(10):
            pair = (("bucketed", opt), ("unbucketed", whole_fn))
            for name, fn in (pair if r % 2 == 0 else pair[::-1]):
                t0 = time.perf_counter()
                logits = fn(params, batch)
                torch.cuda.synchronize()
                walls[name].append(1e3 * (time.perf_counter() - t0))
                if fn is opt:
                    ns.append(opt.last_report.stats.last_dispatch_ns)
                    if not torch.equal(logits, want_out):
                        raise AssertionError("a hit changed the logits")
        med = {k: statistics.median(v) for k, v in walls.items()}
        log(f"[buckets] (a) hits b={b} s={s}: median {med['bucketed']:.3f} ms "
            f"(min {min(walls['bucketed']):.3f} max "
            f"{max(walls['bucketed']):.3f}); in turns with the unbucketed "
            f"plan: median {med['unbucketed']:.3f} ms (min "
            f"{min(walls['unbucketed']):.3f} max "
            f"{max(walls['unbucketed']):.3f}); phase 3, unbucketed: "
            f"{medians[(b, s)]:.3f} ms; 10 calls each; dispatch median "
            f"{statistics.median(ns):.0f} ns per call")
        rows[REQUESTS.index((b, s))].update(
            hit_median_ms=med["bucketed"],
            unbucketed_median_ms=med["unbucketed"],
            phase3_median_ms=medians[(b, s)],
            dispatch_ns=statistics.median(ns))
    del whole_fn
    st = table.stats()
    if table.specialize_count != n_spec or len(captures) != n_cap or \
            st["hits"] != 10 * len(REQUESTS):
        raise AssertionError(f"the second pass recompiled or re-captured: "
                             f"{st}")
    log(f"[buckets] (a) table {st}; rows {json.dumps(rows)}")

    # (b) background specialization: misses are served by the whole-range
    # fallback while the worker compiles; after the drain, hits
    opt_bg = optimize(make_prefill_step(cfg), *specs,
                      dynamic_dims=DYNAMIC_DIMS, buckets="geometric",
                      background_specialize=True)
    tbg = opt_bg.specialization_table
    for i, ((b, s), batch) in enumerate(zip(REQUESTS, batches)):
        t0 = time.perf_counter()
        logits = opt_bg(params, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        if opt_bg.last_arena_bound != opt_bg.arena_bound_bytes:
            raise AssertionError("a miss was not served by the fallback")
        log(f"[buckets] (b) b={b} s={s} miss served by the whole-range "
            f"fallback in {wall:.3f} ms (fallback_serves "
            f"{tbg.fallback_serves}, compiles pending {tbg.n_pending}); "
            f"bitwise equal to phase 3's: {torch.equal(logits, outs[i])}")
        if not torch.equal(logits, outs[i]):
            raise AssertionError("the fallback's logits differ from phase 3")
    t0 = time.perf_counter()
    drained = opt_bg.drain_specializations()
    log(f"[buckets] (b) drain_specializations() {time.perf_counter() - t0:.3f}"
        f" s, drained {drained}")
    if tbg.fallback_serves != len(REQUESTS):
        raise AssertionError(f"fallback_serves {tbg.fallback_serves}")
    for i, ((b, s), batch) in enumerate(zip(REQUESTS, batches)):
        logits = opt_bg(params, batch)
        torch.cuda.synchronize()
        if opt_bg.last_arena_bound != \
                tbg.peek(opt_bg.last_bucket).report.arena_bound_bytes \
                or not torch.equal(logits, got_a[i]):
            raise AssertionError(f"(b) after the drain b={b} s={s} did not "
                                 f"hit its bucket with (a)'s logits")
    log(f"[buckets] (b) after the drain: every request hit its bucket, "
        f"logits bitwise equal to (a)'s; table {tbg.stats()}")
    OBS["background_trace"] = opt_bg.trace

    # (c) the BucketBatcher: admission by bucket arena bound
    bounds = sorted({table.arena_bound_bytes(table.key_of(
        {"b": b, "s": s})) for (b, s) in REQUESTS})
    budget = (bounds[-1] + bounds[-2]) // 2
    batcher = BucketBatcher(opt, memory_budget=budget)
    for (b, s), batch in zip(REQUESTS, batches):
        for _ in range(2):
            batcher.submit({"b": b, "s": s}, payload=(params, batch))
    outcomes = batcher.process()
    for ev in batcher.admission_events:
        log(f"[buckets] (c) admission: {ev}")
    held = batcher.pending_by_bucket()
    big = table.key_of(dict(zip(("b", "s"), REQUESTS[-1])))
    if held != {big: 2} or len(outcomes) != 2 * (len(REQUESTS) - 1):
        raise AssertionError(f"batcher held {held}, ran {len(outcomes)}")
    for oc in outcomes:
        i = REQUESTS.index((oc["env"]["b"], oc["env"]["s"]))
        if not oc["ok"] or not torch.equal(oc["value"], got_a[i]):
            raise AssertionError(f"batcher outcome {oc['env']} differs")
    log(f"[buckets] (c) budget {budget} between bucket bounds {bounds[-2]} "
        f"and {bounds[-1]}: ran {len(outcomes)} requests in "
        f"{len(outcomes) // 2} groups with (a)'s logits; held {held}; "
        f"held_count {batcher.held_count}")
    launches = _launch_counts()
    log(f"[buckets] launches over (a)-(c) {launches}")
    OBS["buckets"] = (opt, params, batches)
    del params, opt, opt_bg, batcher, outcomes, got_a
    torch.cuda.empty_cache()
    return launches


def phase_kernel_select():
    """Phase 7 (d): kernel selection on the kernel_bench step at llama2_1b
    widths, b in [1, 16], s in [1, 2048], buckets on s at 64, in f32 and
    bf16; the model's choice against measured times."""
    import dataclasses

    import torch

    from repro_torch.core import TensorSpec, optimize, symbolic_dims
    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.kernels.hw_model import HardwareModel
    from repro_torch.kernels.variants import (measure_variants, node_shape,
                                              variant_cost, variants_for)

    def fwd(q, k, v, x, scale):
        return flash_attention(q, k, v, True, None, None), \
            rmsnorm(x, scale, 1e-6, None)

    hw = HardwareModel.from_device("cuda")
    # the plain variants' transients rule them out at these shapes; they
    # are timed as well, with the limit lifted, to check the model there
    lifted = dataclasses.replace(hw, max_transient_bytes=1 << 62)
    B, S = symbolic_dims("b, s")
    hq, hd, d = 32, 128, 4096          # llama2_1b's widths
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        specs = [TensorSpec(sh, dtype) for sh in
                 ((B, hq, S, hd), (B, hq, S, hd), (B, hq, S, hd),
                  (B, S, d), (d,))]
        fn = optimize(fwd, *specs, dynamic_dims=KB_RANGES, buckets=KB_EDGES)
        table = fn.specialization_table
        name = str(dtype).split(".")[1]
        for key in table.space.keys():
            bp = table.get(key)
            for sel in bp.plan.kernel_selections.values():
                log(f"[select] {name} bucket {key} "
                    f"{table.space.describe(key)}: {sel.prim_name} -> "
                    f"{sel.variant.name}; model us over the lo/mid/hi "
                    f"corners " + ", ".join(
                        f"{k} {1e6 * v:.1f}" for k, v in sel.scores.items())
                    + f"; invalid {sel.invalid}")
        for env in KB_ENVS:
            key = table.key_of(env)
            before = {nid: s.variant.name for nid, s in
                      table.get(key).plan.kernel_selections.items()}
            forced = fn.remeasure_kernels(env, repeats=KB_REPEATS)
            after = table.peek(key).plan
            for nid, sel in after.kernel_selections.items():
                node = after.node_by_id[nid]
                shape = node_shape(node, env)
                timed = measure_variants(sel.prim_name, node, env, lifted,
                                         repeats=KB_REPEATS,
                                         device=fn.device)
                model = {v.name: variant_cost(sel.prim_name, v, shape, dtype,
                                              {"causal": True}, hw).time_s
                         for v in variants_for(sel.prim_name)
                         if v.name in timed}
                fastest = min(timed, key=timed.get)
                valid_fastest = min(sel.measured_s, key=sel.measured_s.get)
                log(f"[select] {name} at {env}: {sel.prim_name} selected "
                    f"{before[nid]}, measured winner among the valid "
                    f"{valid_fastest} (forced {forced.get(nid)}); ms measured"
                    f" (valid) " + ", ".join(
                        f"{k} {1e3 * v:.4f}" for k, v in sel.measured_s.items())
                    + "; all variants, measured vs model: " + ", ".join(
                        f"{k} {1e3 * timed[k]:.4f} vs {1e3 * model[k]:.4f}"
                        for k in timed)
                    + f"; the model's pick is the measured fastest of all: "
                    f"{before[nid] == fastest}")
                rows.append(dict(dtype=name, env=env, prim=sel.prim_name,
                                 selected=before[nid], forced=forced.get(nid),
                                 measured_ms={k: 1e3 * v for k, v in
                                              timed.items()},
                                 model_ms={k: 1e3 * v for k, v in
                                           model.items()},
                                 picked_fastest=before[nid] == fastest))
        del fn, table
        torch.cuda.empty_cache()
    log(f"[select] rows {json.dumps(rows)}")


def counted_launches(phase):
    """Run ``phase`` with the kernel launch counters set to 0 just before
    it; the launches per route it made, and its result."""
    from repro_torch.kernels import flash_attention_cuda, rmsnorm_cuda
    flash_attention_cuda.launches = 0
    flash_attention_cuda.sm90_launches = 0
    rmsnorm_cuda.launches = 0
    result = phase()
    sm90 = flash_attention_cuda.sm90_launches
    return {"sm90": sm90, "f32": flash_attention_cuda.launches - sm90,
            "rmsnorm": rmsnorm_cuda.launches}, result


# -- phase 8: bounded value-dependent dims (the ragged-batch serve step) -----

# phases 8 and 9 run on DEV (a CPU rehearsal at small widths sets it)
DEV = "cuda"
BOUNDED_D, BOUNDED_F = 4096, 11008          # llama2_1b d_model, d_ff
BOUNDED_ROWS = 8192
BOUNDED_RANGE = (1, 8192)
BOUNDED_OCCS = [1.0, 0.75, 0.5, 0.25, 0.02, 0.0]
BOUNDED_TOL = 5e-2


def _ragged_serve_step(x, mask, w1, w2):
    """``examples/ragged_batch.py``'s serve step: run the FFN on the valid
    rows only (``jax.nn.gelu`` is the tanh approximation)."""
    import torch.nn.functional as F

    from repro_torch.kernels import masked_select
    rows, n_valid = masked_select(x, mask)
    h = F.gelu(rows @ w1, approximate="tanh")
    return (h @ w2).sum(0), n_valid


def _eager_serve_step(x, mask, w1, w2):
    import torch
    import torch.nn.functional as F
    rows = torch.masked_select(x, mask[:, None]).view(-1, x.shape[1])
    h = F.gelu(rows @ w1, approximate="tanh")
    return (h @ w2).sum(0)


def phase_bounded():
    """Phase 8: a bounded dim from ``masked_select`` at llama2_1b widths,
    bf16, one padded batch of 8192 rows at falling occupancy."""
    import torch

    from repro_torch.core import TensorSpec, optimize, symbolic_dims
    from repro_torch.core.ir.dynamism import complete_bound_env

    S, = symbolic_dims("s")
    bf16 = torch.bfloat16
    D, F, n = BOUNDED_D, BOUNDED_F, BOUNDED_ROWS
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8)
    x = torch.randn(n, D, generator=gen, device=DEV).to(bf16)
    w1 = (torch.randn(D, F, generator=gen, device=DEV) * 0.02).to(bf16)
    w2 = (torch.randn(F, D, generator=gen, device=DEV) * 0.02).to(bf16)
    in_bytes = x.nbytes + n + w1.nbytes + w2.nbytes
    t0 = time.perf_counter()
    fn = optimize(_ragged_serve_step, TensorSpec((S, D), bf16),
                  TensorSpec((S,), torch.bool), TensorSpec((D, F), bf16),
                  TensorSpec((F, D), bf16),
                  dynamic_dims={"s": BOUNDED_RANGE}, buckets="geometric",
                  device=DEV)
    compile_s = time.perf_counter() - t0
    (bname, cap), = fn.plan.graph.bound_dims.items()
    log(f"[bounded] optimize {compile_s:.3f} s, bounded dim {bname} <= "
        f"{cap}, graph {fn.plan.graph.stats()}, program "
        f"{fn.program.counts()}, {fn.report.buckets.n_buckets} buckets")
    # warm up cuBLAS and the allocator outside the measured calls
    full = torch.ones(n, dtype=torch.bool, device=DEV)
    fn(x, full, w1, w2)
    torch.cuda.synchronize()
    env = {"s": n}
    rows_out, last_peak = [], None
    for occ in BOUNDED_OCCS:
        keep = int(round(n * occ))
        mask = torch.arange(n, device=DEV) < keep
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - in_bytes
        torch.cuda.reset_peak_memory_stats()
        out, n_valid = fn(x, mask, w1, w2)
        torch.cuda.synchronize()
        peak_alloc = torch.cuda.max_memory_allocated()
        step_alloc = peak_alloc - held
        rep = fn.last_report
        st = rep.stats
        bp = fn.specialization_table.peek(fn.last_bucket)
        prog = bp.program
        measured = st.measured_dims[bname]
        pad = prog.stats_for(prog.resolve(
            complete_bound_env(prog.graph, env))).device_peak
        slack = allocator_slack(prog, rep.env)
        temps = n * 8 + LARGE_OVERHEAD       # the boolean index's indices
        want = _eager_serve_step(x, mask, w1, w2)
        err = (out.float() - want.float()).abs().max().item() \
            if keep else 0.0
        times, syncs = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x, mask, w1, w2)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            syncs.append(fn.last_report.bind_dim_s)
        med = 1e3 * sorted(times)[len(times) // 2]
        sync_us = 1e6 * sorted(syncs)[len(syncs) // 2]
        if occ in (1.0, 0.02):
            profile_once(f"bounded occ={occ}", lambda: fn(x, mask, w1, w2))
        log(f"[bounded] occ {occ}: {bname} measured {measured} n_valid "
            f"{int(n_valid)} bucket {fn.last_bucket} device_peak "
            f"{st.device_peak} pad-to-bound peak {pad} tight/pad "
            f"{st.device_peak / pad:.4f} arena_bytes {st.arena_bytes} "
            f"arena_bound_bytes {fn.last_arena_bound} allocator peak of the "
            f"call {step_alloc} = device_peak + "
            f"{step_alloc - st.device_peak} (slack {slack} + index "
            f"temporaries {temps}) max|out - eager| {err:.3e} median "
            f"{med:.3f} ms BindDim sync {sync_us:.1f} us")
        if measured != keep or int(n_valid) != keep:
            raise AssertionError(f"measured {measured}, n_valid "
                                 f"{int(n_valid)}, want {keep}")
        if last_peak is not None and st.device_peak > last_peak:
            raise AssertionError("device_peak rose as occupancy fell")
        if occ < 1.0 and st.device_peak >= pad:
            raise AssertionError("tight peak not below the pad-to-bound one")
        if st.arena_bytes > fn.last_arena_bound:
            raise AssertionError("arena_bytes above arena_bound_bytes")
        if step_alloc > st.device_peak + slack + temps:
            raise AssertionError(
                f"the allocator's peak of the call, {step_alloc}, is above "
                f"device_peak {st.device_peak} + {slack} + {temps}")
        if keep:
            agree(out, want, BOUNDED_TOL, f"bounded occ {occ} output")
        if tuple(out.shape) != (D,) or not torch.isfinite(out.float()).all():
            raise AssertionError("bad output")
        last_peak = st.device_peak
        OBS["timelines"].append(("bounded", fn, dict(rep.env),
                                 st.device_peak, step_alloc, slack + temps))
        rows_out.append(dict(occ=occ, measured=measured,
                             device_peak=st.device_peak, pad_peak=pad,
                             step_alloc=step_alloc, median_ms=med,
                             bind_dim_us=sync_us))
        del out, n_valid, want
    return rows_out


# -- phase 9: a rolled decode loop (serve_decode's decode_loop) --------------

LOOP_D, LOOP_VOCAB, LOOP_B = 4096, 32000, 4     # llama2_1b widths
LOOP_RANGE = (1, 512)
LOOP_WIDE = (1, 4096)
LOOP_EDGES = {"t": [16, 64]}
LOOP_TOL = 2e-4


def _decode_cell(w, h, p):
    import torch
    h = torch.tanh(h @ w["wh"] + p)
    return h, (h @ w["wv"]).argmax(-1)


def _decode_loop(w, h0, pos):
    from repro_torch.core import scan
    return scan(lambda h, p: _decode_cell(w, h, p), h0.tanh(), pos)


def _decode_unrolled(T):
    def f(w, h0, pos):
        import torch
        h, toks = h0.tanh(), []
        for i in range(T):
            h, tok = _decode_cell(w, h, pos[i])
            toks.append(tok)
        return h, torch.stack(toks)
    return f


def loop_allocator_slack(program, env) -> int:
    """``allocator_slack`` with the loop's outputs and, inside it, the
    body's live values and the second carry generation."""
    from repro_torch.core.lowering.program import OP_LOOP
    extra = 0
    for inst in program.instructions:
        if inst.op != OP_LOOP:
            continue
        nbytes = program.resolve(env).nbytes
        info = program.loops[inst.lidx]
        extra += sum(LARGE_OVERHEAD if nbytes[r] > SMALL_BLOCK
                     else SMALL_OVERHEAD for _oi, r in inst.store)
        extra += allocator_slack(info.body_program, env) + \
            info.body.num_carry * LARGE_OVERHEAD
    return allocator_slack(program, env) + extra


def phase_loop():
    """Phase 9: the rolled decode loop at llama2_1b widths, f32."""
    import torch

    from repro_torch.core import TensorSpec, optimize, scan, symbolic_dims

    D, V, B = LOOP_D, LOOP_VOCAB, LOOP_B
    f32 = torch.float32
    gen = torch.Generator(device=DEV)
    gen.manual_seed(9)
    w = {"wh": torch.randn(D, D, generator=gen, device=DEV) * 0.02,
         "wv": torch.randn(D, V, generator=gen, device=DEV) * 0.02}
    h0 = torch.randn(B, D, generator=gen, device=DEV) * 0.2
    w_specs = {k: TensorSpec(tuple(v.shape), f32) for k, v in w.items()}
    in_bytes = sum(v.nbytes for v in w.values()) + h0.nbytes

    def compile_rolled(t_range, **kw):
        t, = symbolic_dims("t")
        t0 = time.perf_counter()
        fn = optimize(_decode_loop, w_specs, TensorSpec((B, D), f32),
                      TensorSpec((t, D), f32), dynamic_dims={"t": t_range},
                      device=DEV, **kw)
        return fn, time.perf_counter() - t0

    rolled, narrow_s = compile_rolled(LOOP_RANGE, buckets=LOOP_EDGES)
    counts = rolled.program.counts()
    c64, c64_s = compile_rolled((1, 64))
    c4096, c4096_s = compile_rolled(LOOP_WIDE)
    log(f"[loop] optimize t in {LOOP_RANGE} (buckets {LOOP_EDGES}) "
        f"{narrow_s:.3f} s, t in (1, 64) {c64_s:.3f} s, t in {LOOP_WIDE} "
        f"{c4096_s:.3f} s; program {counts}; (1, 64) "
        f"{c64.program.counts()}; {LOOP_WIDE} {c4096.program.counts()}; "
        f"guaranteed_peak_bytes {rolled.guaranteed_peak_bytes} "
        f"arena_bound_bytes {rolled.arena_bound_bytes}")
    if counts["Loop"] != 1:
        raise AssertionError(f"rolled program has {counts['Loop']} Loops")
    if c64.program.counts() != c4096.program.counts():
        raise AssertionError("instruction counts depend on the trip range")
    del c64, c4096

    out = {}
    for T in (1, 17, 512):
        pos = torch.randn(T, D, generator=gen, device=DEV) * 0.1
        rolled(w, h0, pos)                       # bucket compile, warm-up
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - in_bytes - pos.nbytes
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        h, toks = rolled(w, h0, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = rolled.last_report.stats
        step_alloc = torch.cuda.max_memory_allocated() - held
        prog = rolled.specialization_table.peek(rolled.last_bucket).program
        slack = loop_allocator_slack(prog, {"t": T})
        log(f"[loop] T={T}: bucket {rolled.last_bucket} wall "
            f"{1e3 * wall:.3f} ms device_peak {st.device_peak} arena_bytes "
            f"{st.arena_bytes} arena_bound_bytes {rolled.last_arena_bound} "
            f"allocator peak of the call {step_alloc} = device_peak + "
            f"{step_alloc - st.device_peak} (slack {slack}) tokens "
            f"{toks[:4, 0].tolist()}")
        if st.arena_bytes > rolled.last_arena_bound:
            raise AssertionError("arena_bytes above arena_bound_bytes")
        if step_alloc > st.device_peak + slack:
            raise AssertionError(
                f"the allocator's peak of the call, {step_alloc}, is above "
                f"device_peak {st.device_peak} + {slack}")
        if tuple(toks.shape) != (T, B) or not torch.isfinite(h).all():
            raise AssertionError("bad loop outputs")
        OBS["timelines"].append(("loop", rolled, {"t": T}, st.device_peak,
                                 step_alloc, slack))
        out[T] = (pos, h, toks, st.device_peak)

    rows = {}
    for T in (1, 17):
        pos, h, toks, _ = out[T]
        t0 = time.perf_counter()
        unrolled = optimize(_decode_unrolled(T), w_specs,
                            TensorSpec((B, D), f32), TensorSpec((T, D), f32),
                            device=DEV)
        un_s = time.perf_counter() - t0
        uh, utoks = unrolled(w, h0, pos)
        same = torch.equal(uh, h) and torch.equal(utoks, toks)
        reps = 10
        r_ms = time_ms(lambda: rolled(w, h0, pos), reps=reps) / T
        u_ms = time_ms(lambda: unrolled(w, h0, pos), reps=reps) / T
        log(f"[loop] T={T}: rolled == unrolled bitwise {same}; unrolled "
            f"optimize {un_s:.3f} s, program {unrolled.program.counts()}; "
            f"per step rolled {r_ms:.4f} ms unrolled {u_ms:.4f} ms")
        if not same:
            raise AssertionError(f"T={T}: rolled and unrolled differ")
        if T == 17:
            profile_once("loop rolled T=17", lambda: rolled(w, h0, pos))
            profile_once("loop unrolled T=17", lambda: unrolled(w, h0, pos))
        rows[T] = dict(rolled_ms=r_ms, unrolled_ms=u_ms,
                       unrolled_compile_s=un_s)
        del unrolled
    pos, h, toks, peak512 = out[512]
    eh, etoks = scan(lambda hh, p: _decode_cell(w, hh, p), h0.tanh(), pos)
    err = (h - eh).abs().max().item()
    log(f"[loop] T=512: max|h - eager loop| {err:.3e}, tokens equal "
        f"{torch.equal(toks, etoks)}")
    if err > LOOP_TOL:
        raise AssertionError(f"T=512 hidden state {err} from the eager loop")
    step = D * 4 + B * 8                 # one pos row + one int64 token row
    delta = peak512 - out[17][3]
    log(f"[loop] device_peak T=512 - T=17 = {delta}; xs and ys bytes "
        f"{(512 - 17) * step}")
    if delta != (512 - 17) * step:
        raise AssertionError("the peak grew by more than the xs and ys")
    return dict(compile_s={"narrow": narrow_s, "(1,64)": c64_s,
                           "wide": c4096_s}, steps=rows)


# -- phase 10: observability (spans, timelines, telemetry, exports) ---------

OBS_ROUNDS = 100        # (d): interleaved single-call samples per label
OBS_CHECK_ITERS = 100_000
OBS_TOL = 0.02          # (d): the disabled check's share of a call
EXPLAIN_HEADINGS = ("-- compile phases", "-- decisions", "-- arena slots",
                    "-- rematerialization", "-- kernel selection",
                    "-- resilience", "-- plan vs actual @ env")
PROM_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? (\S+)$")


def span_summary(tracer) -> str:
    """Seconds of the first top-level span of each name (the first
    compile), its children in brackets, and the count and seconds of the
    later ones (a recompile, each ``with_memory_limit``'s lowering)."""
    first, later = {}, {}
    for root in tracer.roots:
        if root.name in first:
            n, sec = later.get(root.name, (0, 0.0))
            later[root.name] = (n + 1, sec + root.duration_ns / 1e9)
        else:
            first[root.name] = root
    parts = []
    for name, sp in first.items():
        kids = ", ".join(f"{c.name} {c.duration_ns / 1e9:.3f}"
                         for c in sp.children)
        parts.append(f"{name} {sp.duration_ns / 1e9:.3f} s"
                     + (f" ({kids})" if kids else ""))
    parts += [f"+{n} later {name} {sec:.3f} s"
              for name, (n, sec) in later.items()]
    return "; ".join(parts)


def check_chrome_trace(tracer, path: Path) -> int:
    """Write ``chrome_trace_json(tracer)`` to ``path`` and check it: it
    parses, every complete event carries ts, dur, pid and tid, and every
    child span lies inside its parent's window.  Returns the events."""
    from repro_torch.core.obs import chrome_trace_json
    text = chrome_trace_json(tracer)
    path.write_text(text)
    events = json.loads(text)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        raise AssertionError(f"{path.name}: no complete events")
    for e in spans:
        if not {"name", "ts", "dur", "pid", "tid"} <= set(e) or e["dur"] < 0:
            raise AssertionError(f"{path.name}: malformed event {e}")
    for root in tracer.roots:
        for sp in root.walk():
            for c in sp.children:
                if not sp.t0_ns <= c.t0_ns <= c.t1_ns <= sp.t1_ns:
                    raise AssertionError(f"span {c.name} outside {sp.name}")
    return len(events)


def disabled_path(label, fn, params, batch):
    """(d): the isolated cost of the disabled telemetry check against the
    median call, and interleaved single-call medians of never enabled,
    enabled and re-disabled telemetry (reported only)."""
    import statistics

    import torch

    def sample():
        t0 = time.perf_counter()
        fn(params, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(5):
        sample()
    sinks = {"base": [], "dis": [], "en": []}
    labels = list(sinks)
    enabled = gc.isenabled()
    gc.disable()
    try:
        for r in range(OBS_ROUNDS):
            k = r % 3
            for lab in labels[k:] + labels[:k]:
                if lab == "en":
                    fn.enable_telemetry(capacity=256)
                sinks[lab].append(sample())
                if lab == "en":
                    fn.disable_telemetry()
    finally:
        if enabled:
            gc.enable()
    med = {k: statistics.median(v) for k, v in sinks.items()}
    t0 = time.perf_counter()
    for _ in range(OBS_CHECK_ITERS):
        tel = fn._telemetry
        if tel is not None:
            raise AssertionError("telemetry unexpectedly enabled")
    check_ns = (time.perf_counter() - t0) / OBS_CHECK_ITERS * 1e9
    share = check_ns / (med["dis"] * 1e9)
    row = dict(check_ns=check_ns, share=share,
               base_ms=1e3 * med["base"], dis_ms=1e3 * med["dis"],
               en_ms=1e3 * med["en"],
               disabled_over_base=med["dis"] / med["base"],
               enabled_over_disabled=med["en"] / med["dis"])
    log(f"[obs] (d) {label} (1,16): disabled check {check_ns:.1f} ns = "
        f"{100 * share:.5f}% of the {1e3 * med['dis']:.3f} ms median call "
        f"(contract <= {100 * OBS_TOL:.0f}%); medians over {OBS_ROUNDS} "
        f"interleaved rounds: never enabled {1e3 * med['base']:.3f} ms, "
        f"enabled {1e3 * med['en']:.3f} ms, re-disabled "
        f"{1e3 * med['dis']:.3f} ms; disabled_over_base "
        f"{row['disabled_over_base']:.4f} enabled_over_disabled "
        f"{row['enabled_over_disabled']:.4f} (reported only)")
    if share > OBS_TOL:
        raise AssertionError(f"the disabled check is {100 * share:.3f}% of "
                             f"the call")
    return row


def profile_host(label: str, run) -> None:
    """torch.profiler over one call of ``run``: host time by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    for us, count, key in rows[:10]:
        log(f"[obs] (f) {label}: {us:10.1f} us host x{count:<4d} {key[:80]}")


def phase_obs():
    """Phase 10: compile spans, plan-vs-actual timelines at every observed
    call, the disabled path's cost, telemetry and exports on the bucketed
    path, the first bucketed call taken apart, and explain."""
    import torch

    from repro_torch.configs.llama2_1b import CONFIG
    from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
    from repro_torch.launch.serve import BucketBatcher
    from repro_torch.launch.steps import make_prefill_step

    t_phase = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    prefill, train = OBS["prefill"], OBS["train"]
    bucketed, params, batches = OBS["buckets"]
    out = {}

    # (a) compile spans and the Chrome trace
    for name, fn in (("prefill", prefill), ("train", train),
                     ("buckets", bucketed)):
        n = check_chrome_trace(fn.trace, build / f"obs_trace_{name}.json")
        log(f"[obs] (a) {name} spans: {span_summary(fn.trace)}; chrome "
            f"trace {n} events, valid and nested "
            f"(build/obs_trace_{name}.json)")
        out[f"spans_{name}"] = {r.name: r.duration_ns / 1e9
                                for r in reversed(fn.trace.roots)}

    # (b) the replayed timeline of every observed call
    rows = []
    for label, fn, env, peak, alloc, slack in OBS["timelines"]:
        d = fn.memory_timeline(env)
        a = d.actual
        log(f"[obs] (b) {label} {env}: {len(a.points)} points, replayed "
            f"peak {a.peak_device} predicted {d.predicted_peak_device} live "
            f"device_peak {peak}; allocator peak of the call {alloc} = "
            f"replayed + {alloc - a.peak_device} (slack {slack}); arena "
            f"{a.arena_bytes} <= bound {d.arena_bound_bytes}; unexplained "
            f"{len(d.unexplained)}")
        if not d.ok or d.unexplained:
            raise AssertionError(f"{label} {env}: {d.summary()}")
        if not a.peak_device == d.predicted_peak_device == peak:
            raise AssertionError(f"{label} {env}: replayed {a.peak_device}, "
                                 f"predicted {d.predicted_peak_device}, "
                                 f"live {peak}")
        if alloc > a.peak_device + slack:
            raise AssertionError(f"{label} {env}: allocator {alloc} above "
                                 f"{a.peak_device} + {slack}")
        rows.append(dict(path=label, env=env, points=len(a.points),
                         peak=a.peak_device, alloc=alloc, slack=slack))
    out["timelines"] = rows

    # (d) the disabled path at the host-bound request (1,16)
    small = batches[REQUESTS.index((1, 16))]
    out["disabled"] = {
        "unbucketed": disabled_path("unbucketed", prefill, params, small),
        "bucketed": disabled_path("bucketed", bucketed, params, small)}

    # (e) telemetry and export on the bucketed path
    tel = bucketed.enable_telemetry(capacity=64, sample_timeline_every=2)
    calls = []
    for _ in range(2):
        for batch in batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            bucketed(params, batch)
            ev[1].record()
            calls.append((bucketed.last_report, bucketed.last_bucket, ev))
    torch.cuda.synchronize()
    bucketed.disable_telemetry()
    recs = tel.ring.records()
    if len(recs) != len(calls):
        raise AssertionError(f"ring holds {len(recs)} of {len(calls)} calls")
    for rec, (rep, key, ev) in zip(recs, calls):
        st = rep.stats
        if (rec.env, rec.bucket_key, rec.device_peak, rec.arena_bytes) != \
                (tuple(sorted(rep.env.items())), key, st.device_peak,
                 st.arena_bytes):
            raise AssertionError(f"call {rec.seq}: {rec} against {rep}")
        log(f"[obs] (e) call {rec.seq} {dict(rec.env)} bucket "
            f"{rec.bucket_key}: CallRecord.wall_s {1e3 * rec.wall_s:.3f} ms "
            f"(host) vs CUDA events {ev[0].elapsed_time(ev[1]):.3f} ms; "
            f"dispatch {rec.dispatch_ns} ns; device_peak {rec.device_peak}")
    if [seq for seq, _ in tel.timelines] != list(range(0, len(calls), 2)) \
            or any(tl.peak_device != recs[seq].device_peak
                   for seq, tl in tel.timelines):
        raise AssertionError("sampled timelines do not match the calls")
    log(f"[obs] (e) ring summary {tel.summary()}")
    table = bucketed.specialization_table
    plans = [bucketed.plan] + [table.peek(sp.attrs["bucket"]).plan
                               for sp in bucketed.trace.find("specialize")]
    entries = bucketed.decisions.entries("kernel-select")
    k = len(bucketed.plan.kernel_selections)
    if len(entries) != k * len(plans):
        raise AssertionError(f"{len(entries)} kernel-select decisions for "
                             f"{len(plans)} plans of {k} kernel nodes")
    for i, plan in enumerate(plans):
        chunk = entries[i * k:(i + 1) * k]
        got = {}
        for d in chunk:
            got[d.choice] = got.get(d.choice, 0) + 1
        subjects = [f"%{nid} {sel.prim_name}"
                    for nid, sel in plan.kernel_selections.items()]
        if got != _selection_summary(plan) or \
                [d.subject for d in chunk] != subjects:
            raise AssertionError(f"plan {i}: kernel-select decisions {got} "
                                 f"against selections "
                                 f"{_selection_summary(plan)}")
    log(f"[obs] (e) kernel-select decisions equal the selections of "
        f"{len(plans)} plans (whole range + buckets "
        f"{[sp.attrs['bucket'] for sp in bucketed.trace.find('specialize')]})"
        f"; e.g. {entries[0].subject} -> {entries[0].choice}: "
        f"{entries[0].why}")
    batcher = BucketBatcher(bucketed)
    for (b, s) in REQUESTS:
        batcher.submit({"b": b, "s": s})
    batcher.drain()
    text = batcher.metrics_text()
    kinds, n_samples = {}, 0
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split()
            kinds[name] = kind
        elif ln and not ln.startswith("#"):
            m = PROM_SAMPLE.match(ln)
            if m is None or m.group(1) not in kinds:
                raise AssertionError(f"not Prometheus text: {ln!r}")
            float(m.group(3))
            n_samples += 1
    (build / "obs_metrics.txt").write_text(text)
    log(f"[obs] (e) metrics_text: {len(kinds)} families, {n_samples} "
        f"samples, every sample typed and parsed ({sorted(kinds)})")

    # (f) where the first bucketed call's time went
    fc = OBS["first_call"]
    specs = bucketed.trace.find("specialize")
    for sp in specs + OBS["background_trace"].find("specialize"):
        log(f"[obs] (f) specialize bucket {sp.attrs['bucket']} background "
            f"{sp.attrs['background']}: {sp.duration_ns / 1e9:.3f} s "
            f"({', '.join(f'{c.name} {c.duration_ns / 1e9:.3f}' for c in sp.children)})")
    spec_s = specs[0].duration_ns / 1e9
    gc_s = sum(sec for _, sec in fc["gc"])
    rest = fc["wall_s"] - fc["dispatch_ns"] / 1e9 - fc["run_s"]
    log(f"[obs] (f) first bucketed call of the run {fc['env']}: wall "
        f"{fc['wall_s']:.3f} s = dispatch {fc['dispatch_ns'] / 1e9:.3f} s "
        f"(its bucket's specialize span {spec_s:.3f} s) + VM run (host) "
        f"{fc['run_s']:.3f} s + the rest {rest:.3f} s (arguments, the wait "
        f"for the card); device time {fc['device_ms']:.3f} ms by CUDA "
        f"events; {len(fc['gc'])} garbage collections inside the call, "
        f"{gc_s:.3f} s (the longest "
        f"{max(fc['gc'], key=lambda g: g[1], default=(None, 0.0))})")
    out["first_call"] = dict(fc, gc=len(fc["gc"]), specialize_s=spec_s,
                             gc_s=gc_s, rest_s=rest)
    unexplained = fc["wall_s"] - spec_s - fc["device_ms"] / 1e3
    if unexplained > 0.1:
        B, S = symbolic_dims("b, s")
        fresh = optimize(make_prefill_step(CONFIG), spec_like(params),
                         {"tokens": TensorSpec((B, S), torch.int32)},
                         dynamic_dims=DYNAMIC_DIMS, buckets="geometric")
        profile_host("a fresh bucketed plan's first call",
                     lambda: fresh(params, small))
        del fresh

    # (g) explain at the largest request
    big = dict(zip(("b", "s"), REQUESTS[-1]))
    text = prefill.explain(big)
    (build / "obs_explain_prefill.txt").write_text(text)
    heads = [ln for ln in text.splitlines() if ln.startswith("-- ")]
    log(f"[obs] (g) explain({big}) of the prefill plan: "
        f"{len(text.splitlines())} lines (build/obs_explain_prefill.txt); "
        f"headings {[h.rstrip(' -') for h in heads]}")
    missing = [h for h in EXPLAIN_HEADINGS
               if not any(x.startswith(h) for x in heads)]
    if missing or "verdict: OK" not in text:
        raise AssertionError(f"explain lacks {missing} or its verdict")
    log(f"[obs] phase 10 {time.perf_counter() - t_phase:.1f} s; rows "
        f"{json.dumps(out, default=str)}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    t_start = time.perf_counter()
    name, smi_line = phase_device()
    rows = phase_kernels()
    cfg, params, opt_ref, batches, outs, launches, req_rows, medians = \
        phase_main_path()
    plain = phase_plain(cfg, params, opt_ref, batches, outs)
    del params, opt_ref
    f32_launches = phase_f32_path()
    train = phase_train()
    buckets = phase_buckets(cfg, batches, outs, plain, medians)
    del outs, plain
    phase_kernel_select()
    bounded_launches, _ = counted_launches(phase_bounded)
    loop_launches, _ = counted_launches(phase_loop)
    phase_obs()

    big = rows[REQUESTS[-1]]
    flash_src = "src/repro/kernels/flash_attention.py:31"
    kernels = []
    for key, route_name, src_path, replaces, by_path in (
            ("flash_bfloat16", "flash_attention_sm90_bf16",
             "src/repro_torch/csrc/flash_attention_sm90.cu", flash_src,
             {"prefill": launches["flash_attention_sm90"],
              "train": train["flash_attention_sm90"],
              "buckets": buckets["sm90"],
              "bounded": bounded_launches["sm90"],
              "loop": loop_launches["sm90"]}),
            ("flash_float32", "flash_attention_simt_f32",
             "src/repro_torch/csrc/flash_attention.cu", flash_src,
             {"prefill_f32": f32_launches,
              "train": train["flash_attention_f32"],
              "buckets": buckets["f32"],
              "bounded": bounded_launches["f32"],
              "loop": loop_launches["f32"]}),
            ("rmsnorm", "rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:17",
             {"prefill": launches["rmsnorm"], "train": train["rmsnorm"],
              "buckets": buckets["rmsnorm"],
              "bounded": bounded_launches["rmsnorm"],
              "loop": loop_launches["rmsnorm"]})):
        r = big[key]
        kernels.append({"name": route_name, "route": "cuda",
                        "source": src_path, "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"],
                        "bound_by": r["by"], "library_ms": r["lib"]})
    log(f"[done] total {time.perf_counter() - t_start:.1f} s; kernel numbers "
        f"at (b, s) = {REQUESTS[-1]}; launches per path, each counted from 0 "
        f"just before the path and read just after it (the f32 route runs "
        f"only on the f32 path); requests {json.dumps(req_rows)}")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
