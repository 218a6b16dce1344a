#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: card name and power limit, TF32 off, kernels built from
   ``src/repro_torch/csrc`` (build seconds, ptxas register/smem report);
2. kernels against their plain PyTorch versions at the main path's shapes
   and layout and at the reference kernel tests' shapes, f32 and bf16
   (elementwise rtol = atol and ||got - want|| / ||want|| both within
   2e-4 / 1e-2), with kernel, plain and library-call times and the card's
   bound for the same work;
3. main path: ``optimize(make_prefill_step(llama2_1b))`` at full width
   (4 layers, bf16, random weights from seed 0), serving four requests of
   different (b, s) through one plan; asserts 4 flash-attention and 9
   RMSNorm launches per request, device_peak <= guaranteed_peak_bytes,
   the caching allocator's real peak of the request within device_peak
   plus the allocator's block overheads, arena_bytes <= arena_bound_bytes,
   finite logits, a single capture;
   then, outside the counted run, the median wall time per request shape
   and a torch.profiler breakdown of device time by kernel;
4. the same requests through the plain path (``impl="ref"``): logits agree
   to 5e-2.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
    return name, smi_line


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

    # correctness: test shapes in both dtypes, then every main-path shape
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for (b, hq, hkv, s, t, hd) in FLASH_TEST_SHAPES:
            for causal in (True, False):
                q = randn((b, hq, s, hd), dtype)
                k, v = randn((b, hkv, t, hd), dtype), randn((b, hkv, t, hd), dtype)
                agree(flash_attention_cuda(q, k, v, causal=causal),
                      reference_attention(q, k, v, causal=causal), tol,
                      f"flash {(b, hq, hkv, s, t, hd)} {dtype}")
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
        # transposed; f32 holds the kernel's arithmetic at 2e-4, bf16 is
        # the served dtype whose numbers are kept
        qkv32 = [randn((b, s, cfg_hq, cfg_hd), torch.float32).transpose(1, 2)
                 for _ in range(3)]
        x32 = randn((b * s, cfg_d), torch.float32)
        sc32 = randn((cfg_d,), torch.float32, 0.1)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v = (t.to(dtype) for t in qkv32)
            f_err, f_rel = agree(flash_attention_cuda(q, k, v, causal=True),
                                 reference_attention(q, k, v, causal=True),
                                 TOL[name], f"flash (b={b}, s={s}) {name}")
            x, sc = x32.to(dtype), sc32.to(dtype)
            n_err, n_rel = agree(rmsnorm_cuda(x, sc), reference_rmsnorm(x, sc),
                                 TOL[name], f"rmsnorm ({b * s},{cfg_d}) {name}")
            log(f"[kernels] (b={b}, s={s}) {name} vs plain: flash max err "
                f"{f_err:.3g} rel norm {f_rel:.3g}; rmsnorm max err "
                f"{n_err:.3g} rel norm {n_rel:.3g} (tol {TOL[name]})")
        f_ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal=True))
        f_plain = time_ms(lambda: reference_attention(q, k, v, causal=True),
                          reps=5)
        f_lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        f_bound, f_by = flash_bound(b, cfg_hq, cfg_hq, s, s, cfg_hd,
                                    "bfloat16", 2)
        n_ms = time_ms(lambda: rmsnorm_cuda(x, sc))
        n_plain = time_ms(lambda: reference_rmsnorm(x, sc))
        w = 1.0 + sc
        n_lib = time_ms(lambda: F.rms_norm(x, (cfg_d,), w, 1e-6))
        n_bound, n_by = rmsnorm_bound(b * s, cfg_d, "bfloat16", 2)
        log(f"[kernels] flash (b={b},h={cfg_hq},s={s},hd={cfg_hd}) bf16: "
            f"err {f_err:.3g} kernel {f_ms:.4f} ms plain {f_plain:.4f} ms "
            f"sdpa {f_lib:.4f} ms bound {f_bound:.4f} ms ({f_by})")
        log(f"[kernels] rmsnorm ({b * s},{cfg_d}) bf16: err {n_err:.3g} "
            f"kernel {n_ms:.4f} ms plain {n_plain:.4f} ms F.rms_norm "
            f"{n_lib:.4f} ms bound {n_bound:.4f} ms ({n_by})")
        rows[(b, s)] = dict(
            flash=dict(err=f_err, ms=f_ms, plain=f_plain, lib=f_lib,
                       bound=f_bound, by=f_by),
            rmsnorm=dict(err=n_err, ms=n_ms, plain=n_plain, lib=n_lib,
                         bound=n_bound, by=n_by))
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
    rmsnorm_cuda.launches = 0
    outs, rows = [], []
    for (b, s), batch in zip(REQUESTS, batches):
        f0, n0 = flash_attention_cuda.launches, rmsnorm_cuda.launches
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
        nl = rmsnorm_cuda.launches - n0
        token = logits.float().argmax(-1).tolist()
        log(f"[main] request b={b} s={s}: wall {1e3 * wall:.3f} ms "
            f"next_token {token[:4]} device_peak {st.device_peak} "
            f"guaranteed_peak_bytes {opt.guaranteed_peak_bytes} "
            f"arena_bytes {st.arena_bytes} arena_bound_bytes "
            f"{opt.arena_bound_bytes} max_memory_allocated {peak_alloc} "
            f"held outside the step {held} allocator peak of the step "
            f"{step_alloc} (device_peak + {step_alloc - st.device_peak}; "
            f"block-overhead slack {slack}) launches flash {fl} rmsnorm {nl}")
        if tuple(logits.shape) != (b, cfg.vocab):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits.float()).all():
            raise AssertionError("non-finite logits")
        if fl != cfg.n_layers or nl != 2 * cfg.n_layers + 1:
            raise AssertionError(f"launches flash {fl} rmsnorm {nl} per "
                                 f"request")
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
    shapes (torch.profiler), and the share of the request's wall time with
    a kernel running.  Runs after the main path's launch counts are read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for (b, s), batch in ((REQUESTS[0], batches[0]),
                          (REQUESTS[-1], batches[-1])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt(params, batch)
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
            log(f"[profile] b={b} s={s}: no device time recorded "
                f"(device busy share not measured)")
            continue
        log(f"[profile] b={b} s={s}: wall {wall_us:.0f} us, kernel time "
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
        torch.testing.assert_close(got.float(), ref.float(), rtol=5e-2,
                                   atol=5e-2)
        eager = step(params, batch)
        torch.cuda.synchronize()
        log(f"[plain] b={b} s={s}: max |kernel path - plain path| {err:.4g}; "
            f"VM output bitwise equal to eager step: "
            f"{bool(torch.equal(got, eager))}")


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

    big = rows[REQUESTS[-1]]
    kernels = []
    for key, route_name, src_path, replaces in (
            ("flash", "flash_attention",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:31"),
            ("rmsnorm", "rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:17")):
        r = big[key]
        kernels.append({"name": route_name, "route": "cuda",
                        "source": src_path, "replaces": replaces,
                        "launches": launches[route_name],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"],
                        "bound_by": r["by"], "library_ms": r["lib"]})
    log(f"[done] total {time.perf_counter() - t_start:.1f} s; kernel numbers "
        f"at (b, s) = {REQUESTS[-1]}; requests {json.dumps(req_rows)}")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
