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

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
        opt_ref = optimize(make_prefill_step(cfg, impl="ref"), *specs,
                           dynamic_dims=DYNAMIC_DIMS)
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
    phase_latency(opt, params, batches)
    phase_profile(opt, params, batches)
    return cfg, params, opt_ref, batches, outs, launches, rows


def phase_latency(opt, params, batches, reps: int = 10):
    """Median and max wall time per request shape over ``reps`` calls,
    each ending in ``synchronize()`` (after the counted run)."""
    import statistics

    import torch
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


def phase_plain(cfg, params, opt_ref, batches, outs):
    import torch
    from repro_torch.launch.steps import make_prefill_step
    step = make_prefill_step(cfg)
    for (b, s), batch, got in zip(REQUESTS, batches, outs):
        ref = opt_ref(params, batch)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        eager = step(params, batch)
        torch.cuda.synchronize()
        log(f"[plain] b={b} s={s}: max |kernel path - plain path| {err:.4g}; "
            f"VM output bitwise equal to eager step: "
            f"{bool(torch.equal(got, eager))}")
        torch.testing.assert_close(got.float(), ref.float(), rtol=5e-2,
                                   atol=5e-2)


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
                       dynamic_dims=DYNAMIC_DIMS)
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
    cfg, params, opt_ref, batches, outs, launches, req_rows = phase_main_path()
    phase_plain(cfg, params, opt_ref, batches, outs)
    del params, opt_ref, outs
    f32_launches = phase_f32_path()
    train = phase_train()

    big = rows[REQUESTS[-1]]
    flash_src = "src/repro/kernels/flash_attention.py:31"
    kernels = []
    for key, route_name, src_path, replaces, by_path in (
            ("flash_bfloat16", "flash_attention_sm90_bf16",
             "src/repro_torch/csrc/flash_attention_sm90.cu", flash_src,
             {"prefill": launches["flash_attention_sm90"],
              "train": train["flash_attention_sm90"]}),
            ("flash_float32", "flash_attention_simt_f32",
             "src/repro_torch/csrc/flash_attention.cu", flash_src,
             {"prefill_f32": f32_launches,
              "train": train["flash_attention_f32"]}),
            ("rmsnorm", "rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:17",
             {"prefill": launches["rmsnorm"], "train": train["rmsnorm"]})):
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
