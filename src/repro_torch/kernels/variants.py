"""Kernel-variant registry + the Hopper cost model.

Port of ``repro/kernels/variants.py``, rebuilt for the routes the port
really has.  Buckets specialize *memory plans*; this module lets them
specialize *kernels* too.  Every selectable kernel op registers its
variants — the hand-written CUDA kernels and the plain PyTorch version —
and a cost function that prices one variant at one concrete shape from
the :class:`~repro_torch.kernels.hw_model.HardwareModel` constants:

* **tensor-core / f32 time** — FLOPs over the rate of the unit that does
  them (bf16 ``wgmma`` and ``mma.sync`` on the tensor cores, f32 products
  as three TF32 ones, the softmax on the f32 units);
* **HBM time** — bytes moved, including the K/V tiles each q block
  re-reads and, for the plain versions, every round trip of their
  intermediates (the f32 score matrix, the f32 copies);
* **occupancy** — a kernel's grid in waves over the SMs, each SM holding
  as many CTAs as its shared memory, registers and threads allow;
* **launches** — ``hw.launch_s`` per kernel launch: one for a CUDA
  kernel, one per aten op for a plain version.

Each variant's time is divided by an efficiency calibrated once from its
measured time at one (8,1024) row of ``PERF.md``'s kernel table
(``CALIBRATION`` below names the row): the model keeps the shape
of the roofline and the measured distance from it.

**Validity** is judged at the range's *upper* corner (every quantity is
monotone in every dim), so the whole-range fallback plan can never adopt
a variant that some in-range shape breaks.  A variant is valid when

* the tensor's dtype is one its kernel takes (``sm90_*`` and
  ``mma_bf16_*``: bfloat16, ``mma_f32_*``: float32, ``cuda_*``: float32
  or bfloat16, ``ref_*``: any);
* a flash kernel's head dim is one its route takes at that dtype, the
  op's own rule (``flash_attention.route_of``): the sm90 kernel at
  ``HEAD_DIMS``, the mma kernel at any other head dim up to
  ``MAX_HEAD_DIM`` in bfloat16 and at every one in float32, so a plan
  never selects a kernel that its inputs would route elsewhere;
* its shared memory fits the per-block opt-in limit;
* the device memory it allocates inside the op, beyond the output the
  plan counts, fits ``hw.max_transient_bytes``.  On the TPU the dense
  path's score matrix sat in VMEM; on the card ``ref_dense`` allocates
  ``b·hq·s·t·4`` bytes of f32 scores (twice: the masked scores and the
  probabilities) that the memory plan does not see — 2 GiB at
  (8, 32, 1024, 1024) — so where they could exceed what the allocator
  check grants one op, the plain version is not selectable.

Selection happens per compiled plan (:func:`select_kernels`): a kernel
node's dims are bounded by the plan's ``ShapeGraph`` intervals — a
bucket's narrowed ranges, or the whole declared range — the cost model
scores every valid variant at the range's lo / geometric-mid / hi
corners, and the cheapest total wins.  The winner's name is baked into
the lowered ``Compute`` as the op's ``impl`` argument.  The scores, the
invalid variants with the reason and any measured times live on the
returned :class:`KernelSelection`; given a ``DecisionLog``,
:func:`select_kernels` also logs one ``kernel-select`` decision per
kernel node.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch

from .flash_attention import HEAD_DIMS, MAX_HEAD_DIM, route_of
from .hw_model import DEFAULT_HW, HardwareModel
from .rmsnorm import CTA_THREADS, MAX_SMEM_BYTES, rmsnorm_geometry

# dims the cost model probes when a range has no upper bound: a pricing
# point only — validity never relies on it (an unbounded transient or
# shared-memory footprint is invalid)
_UNBOUNDED_PROBE = 4096
MMA_HEAD_DIMS = (16, 32, 48, 64, 128, 256)  # the mma flash kernel's instances

# the port's kernel ops (captured node ``prim_name``) -> registry key
PRIM_KEYS = {"repro_torch.flash_attention.default": "flash_attention",
             "repro_torch.rmsnorm.default": "rmsnorm"}


# ---------------------------------------------------------------------------
# variant + cost containers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelVariant:
    """One selectable implementation of a kernel op.

    ``route`` is ``"ref"`` for the plain PyTorch version, else the CUDA
    kernel's route; ``dtypes`` the input dtypes it takes (empty: any).
    ``block`` holds the kernel's compile-time tile sizes (sorted name /
    value pairs), ``threads`` its CTA size and ``regs_per_cta`` the
    registers one CTA holds (0 where the source does not fix them).
    Where an instance's tiles follow the head dim, :func:`variant_block`
    gives the ones it runs."""

    name: str
    route: str
    dtypes: Tuple[torch.dtype, ...] = ()
    block: Tuple[Tuple[str, int], ...] = ()
    threads: int = 0
    regs_per_cta: int = 0

    def overrides(self) -> Dict[str, Any]:
        """The op arguments that realize this variant."""
        return {"impl": self.name}

    def block_of(self, name: str, default: int = 0) -> int:
        return dict(self.block).get(name, default)

    def takes(self, dtype: torch.dtype) -> bool:
        return not self.dtypes or dtype in self.dtypes


@dataclass(frozen=True)
class VariantCost:
    """One variant priced at one concrete shape."""

    time_s: float
    flops: float
    hbm_bytes: float
    launches: int


@dataclass
class KernelSelection:
    """The outcome of selecting one kernel node over one shape range."""

    node_id: int
    prim_name: str
    variant: KernelVariant
    default: KernelVariant
    scores: Dict[str, float]                 # variant name -> summed time_s
    bounds: Dict[str, Tuple[int, Optional[int]]]  # dim label -> (lo, hi)
    probes: List[Dict[str, int]] = field(default_factory=list)
    # variant name -> why it cannot serve the range's hi corner
    invalid: Dict[str, str] = field(default_factory=dict)
    measured: bool = False                   # True after a measured re-select
    # variant name -> best measured seconds (measured re-selection only)
    measured_s: Dict[str, float] = field(default_factory=dict)

    @property
    def is_default(self) -> bool:
        return self.variant.name == self.default.name

    @property
    def model_speedup(self) -> float:
        """Predicted default-time / selected-time over the probe corners."""
        sel = self.scores.get(self.variant.name, 0.0)
        def_ = self.scores.get(self.default.name, sel)
        return def_ / sel if sel > 0 else 1.0

    def describe_bounds(self) -> str:
        return " ".join(f"{name}∈[{lo},{'∞' if hi is None else hi}]"
                        for name, (lo, hi) in self.bounds.items())


# ---------------------------------------------------------------------------
# the variants
# ---------------------------------------------------------------------------

SM90 = KernelVariant(
    name="sm90_bm128_bn128", route="sm90", dtypes=(torch.bfloat16,),
    block=(("block_kv", 128), ("block_q", 128)), threads=384,
    # setmaxnreg: 24 registers for the producer warpgroup, 240 for each of
    # the two consumer warpgroups (csrc/flash_attention_sm90.cu)
    regs_per_cta=128 * 24 + 256 * 240)
# csrc/flash_attention_mma.cu: 4 warps, 64 q rows, 64-key tiles (fewer at
# hd 256 and at f32 hd 128: ``variant_block``), one variant per dtype
# ptxas -v on the H100 build (chip_smoke.py phase 1): the most any of a
# variant's six instances takes is charged, 228 registers a thread in f32
# (hd 256) and 252 in bf16 (hd 256)
MMA_F32 = KernelVariant(
    name="mma_f32_bq64_bkv64", route="mma", dtypes=(torch.float32,),
    block=(("block_kv", 64), ("block_q", 64)), threads=128,
    regs_per_cta=128 * 228)
MMA_BF16 = KernelVariant(
    name="mma_bf16_bq64_bkv64", route="mma", dtypes=(torch.bfloat16,),
    block=MMA_F32.block, threads=MMA_F32.threads, regs_per_cta=128 * 252)
REF_DENSE = KernelVariant(name="ref_dense", route="ref")
FLASH_VARIANTS: Tuple[KernelVariant, ...] = (SM90, MMA_F32, MMA_BF16,
                                             REF_DENSE)

# csrc/rmsnorm.cu: rows held in registers, several a CTA of 256 threads
# (``rmsnorm.rmsnorm_geometry`` gives the rows a CTA and the path per d)
REG_ROWS = KernelVariant(name="cuda_reg_rows", route="cuda",
                         dtypes=(torch.float32, torch.bfloat16),
                         threads=CTA_THREADS)
REF_UNFUSED = KernelVariant(name="ref_unfused", route="ref")
RMSNORM_VARIANTS: Tuple[KernelVariant, ...] = (REG_ROWS, REF_UNFUSED)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def mma_instance(hd: int) -> int:
    """The mma kernel's instance that runs head dim ``hd``: the smallest
    of ``MMA_HEAD_DIMS`` at least ``hd`` (``csrc/flash_attention_mma.cu``'s
    dispatch), its columns past ``hd`` zero."""
    return next(h for h in MMA_HEAD_DIMS if h >= hd)


def flash_hd_invalid_reason(variant: KernelVariant, hd: Optional[int],
                            dtype: torch.dtype) -> Optional[str]:
    """Why a flash kernel variant's route is not the one the op's route
    rule (``route_of``) gives ``hd`` at ``dtype``, or ``None``."""
    if variant.route == "ref":
        return None
    if hd is None or not 1 <= hd <= MAX_HEAD_DIM:
        return f"head dim {hd} not in 1..{MAX_HEAD_DIM}"
    want = route_of(dtype, hd)
    if variant.route != want:
        return f"head dim {hd} in {dtype} takes the {want} kernel"
    return None


def variant_block(variant: KernelVariant,
                  shape: Mapping[str, Optional[int]]) -> Dict[str, int]:
    """The tile sizes ``variant`` runs at ``shape``: its ``block``, but
    the sm90 kernel's hd-256 instance takes 64-key tiles
    (``Geo<HD>::BN`` in ``csrc/flash_attention_sm90.cu``), as 128-key
    ones would need 320 KiB of shared memory, and the mma kernel's f32
    instances at hd 128 and 256 take 32-key tiles and its bf16 one at 256
    16-key tiles (``Geo<HD, Elem>::BN`` in ``csrc/flash_attention_mma.cu``).
    """
    block = dict(variant.block)
    hd = shape.get("hd")
    if variant.route == "sm90" and hd == 256:
        block["block_kv"] = 64
    if variant.route == "mma" and hd is not None and hd <= MAX_HEAD_DIM:
        inst, f32 = mma_instance(hd), variant.dtypes[0].itemsize == 4
        if inst == 256:
            block["block_kv"] = 32 if f32 else 16
        elif inst == 128 and f32:
            block["block_kv"] = 32
    return block


# ---------------------------------------------------------------------------
# footprints: shared memory and hidden transient device bytes
# ---------------------------------------------------------------------------


def variant_smem_bytes(prim_name: str, variant: KernelVariant,
                       hi_shape: Mapping[str, Optional[int]],
                       dtype: Optional[torch.dtype] = None
                       ) -> Optional[int]:
    """Shared memory one CTA of the variant takes (``None``: unboundable).
    RMSNorm's is its geometry's at ``d`` in ``dtype``; without either, the
    most any geometry takes."""
    if variant.route == "ref":
        return 0
    if prim_name == "rmsnorm":
        d = hi_shape.get("d")
        if d is None or dtype is None:
            return MAX_SMEM_BYTES
        return rmsnorm_geometry(d, dtype).smem_bytes
    hd = hi_shape.get("hd")
    if hd is None:
        return None
    if variant.route == "sm90":
        # csrc/flash_attention_sm90.cu Geo<HD>::SMEM: the 128-row Q tile,
        # 2 K and 2 V tiles of block_kv rows, 5 mbarriers and 1 KB
        # alignment slack, at least 116 KB
        block = variant_block(variant, hi_shape)
        q_tile = block["block_q"] * hd * 2
        kv_tile = block["block_kv"] * hd * 2
        return max(q_tile + 4 * kv_tile + 64 + 1024, 116 * 1024)
    # csrc/flash_attention_mma.cu Geo<HD, Elem>::SMEM of the instance HD
    # that runs hd: the Q tile and 2 stages of K and V tiles, every row
    # padded by 16 bytes
    if hd > MAX_HEAD_DIM:
        return None
    block = variant_block(variant, hi_shape)
    size = variant.dtypes[0].itemsize
    return (block["block_q"] + 4 * block["block_kv"]) \
        * (mma_instance(hd) + 16 // size) * size


def _prod(*xs: Optional[int]) -> Optional[int]:
    out = 1
    for x in xs:
        if x is None:
            return None
        out *= x
    return out


def variant_transient_bytes(prim_name: str, variant: KernelVariant,
                            shape: Mapping[str, Optional[int]], itemsize: int
                            ) -> Optional[int]:
    """Device bytes the variant allocates inside the op beyond its output
    (``None``: unbounded).  The CUDA kernels allocate nothing; the plain
    versions' intermediates, summed (an upper bound on what is live at
    once), as ``kernels/ref.py`` computes them."""
    if variant.route != "ref":
        return 0
    conv = 4 if itemsize != 4 else 0          # an f32 working copy
    if prim_name == "flash_attention":
        b, hq, hkv = shape.get("b"), shape.get("hq"), shape.get("hkv")
        s, t, hd = shape.get("s"), shape.get("t"), shape.get("hd")
        scores = _prod(b, hq, s, t)
        q_elems, kv_elems = _prod(b, hq, s, hd), _prod(b, hkv, t, hd)
        if scores is None or q_elems is None or kv_elems is None:
            return None
        # masked scores and probabilities (f32), the scaled f32 q, f32
        # copies of k and v, the f32 output before its cast
        return 2 * 4 * scores + 4 * q_elems + conv * 2 * kv_elems \
            + 4 * q_elems
    n, d = shape.get("n"), shape.get("d")
    elems = _prod(n, d)
    if elems is None:
        return None
    # x*x and x*rsqrt(...) in f32, plus x's f32 copy for a narrower dtype
    return (8 + conv) * elems


def variant_invalid_reason(prim_name: str, variant: KernelVariant,
                           hi_shape: Mapping[str, Optional[int]],
                           dtype: torch.dtype,
                           hw: HardwareModel = DEFAULT_HW) -> Optional[str]:
    """Why the variant cannot serve every shape up to ``hi_shape``
    (``None`` dims = unbounded), or ``None`` when it can."""
    if not variant.takes(dtype):
        return f"takes {'/'.join(str(d) for d in variant.dtypes)}, not {dtype}"
    if prim_name == "flash_attention":
        why = flash_hd_invalid_reason(variant, hi_shape.get("hd"), dtype)
        if why is not None:
            return why
    smem = variant_smem_bytes(prim_name, variant, hi_shape, dtype)
    if smem is None or smem > hw.smem_per_block_optin:
        return (f"shared memory {smem} B over the per-block "
                f"{hw.smem_per_block_optin} B")
    tb = variant_transient_bytes(prim_name, variant, hi_shape,
                                 dtype.itemsize)
    if tb is None or tb > hw.max_transient_bytes:
        what = "unbounded" if tb is None else f"{tb} B"
        return (f"transient device bytes {what} over max_transient_bytes "
                f"{hw.max_transient_bytes} B")
    return None


def variant_valid(prim_name: str, variant: KernelVariant,
                  hi_shape: Mapping[str, Optional[int]], dtype: torch.dtype,
                  hw: HardwareModel = DEFAULT_HW) -> bool:
    return variant_invalid_reason(prim_name, variant, hi_shape, dtype,
                                  hw) is None


# ---------------------------------------------------------------------------
# cost models
# ---------------------------------------------------------------------------


def _causal_block_pairs(nq: int, nk: int, bq: int, bkv: int) -> int:
    """Tiles the causal kernel actually runs: for q block ``qi`` only kv
    tiles at or below the diagonal, ≈ half the grid for square shapes."""
    total = 0
    for qi in range(nq):
        total += min(nk, (qi * bq + bq - 1) // bkv + 1)
    return total


def _fill(grid: int, variant: KernelVariant, smem: int,
          hw: HardwareModel) -> float:
    """Fraction of the card's CTA slots the grid keeps busy over its
    waves (1.0 for a grid of whole waves)."""
    per_sm = hw.max_threads_per_sm // max(variant.threads, 1)
    if smem:
        per_sm = min(per_sm, hw.smem_per_sm // smem)
    if variant.regs_per_cta:
        per_sm = min(per_sm, hw.regs_per_sm // variant.regs_per_cta)
    slots = hw.sm_count * max(per_sm, 1)
    waves = _ceil_div(max(grid, 1), slots)
    return max(grid, 1) / (waves * slots)


def _ref_dense_launches(itemsize: int, causal: bool) -> int:
    """aten launches of ``ref.reference_attention`` through the op: scale
    q, two einsums, softmax, the op's output copy; the causal mask (two
    aranges, compare, full, where); f32 casts of q, k, v and back."""
    return 5 + (5 if causal else 0) + (4 if itemsize != 4 else 0)


def flash_cost(variant: KernelVariant, shape: Mapping[str, int],
               dtype: torch.dtype, params: Mapping[str, Any],
               hw: HardwareModel = DEFAULT_HW, eff: float = 1.0
               ) -> VariantCost:
    """Price one flash-attention variant at one concrete shape."""
    b, hq, hkv = shape["b"], shape["hq"], shape["hkv"]
    s, t, hd = shape["s"], shape["t"], shape["hd"]
    itemsize = dtype.itemsize
    causal = bool(params.get("causal", True))
    if variant.route == "ref":
        # dense f32 attention, no causal skipping: both products on the
        # f32 units (TF32 off); the scores written, masked, soft-maxed and
        # read back; q/k/v cast to f32 and the output cast back
        scores = b * hq * s * t
        flops_fp32 = 4.0 * scores * hd + 6.0 * scores
        q_b = (18 if itemsize != 4 else 12) * b * hq * s * hd
        kv_b = 2 * (10 if itemsize != 4 else 4) * b * hkv * t * hd
        o_b = (14 if itemsize != 4 else 12) * b * hq * s * hd
        hbm = 6 * 4 * scores + q_b + kv_b + o_b
        launches = _ref_dense_launches(itemsize, causal)
        compute_s = flops_fp32 / hw.fp32_flops
        work = (compute_s + hbm / hw.hbm_bw) / eff
        time = work + launches * hw.launch_s
        return VariantCost(time, flops_fp32, hbm, launches)

    block = variant_block(variant, shape)
    bq, bkv = block["block_q"], block["block_kv"]
    nq, nk = _ceil_div(s, bq), _ceil_div(t, bkv)
    pairs = _causal_block_pairs(nq, nk, bq, bkv) if causal else nq * nk
    tile = bq * bkv
    if variant.route == "sm90":
        # Q·Kᵀ plus P·V with P as two bf16 terms: half again the tensor
        # work of one P·V (flash_attention_sm90.cu, "P enters as two bf16
        # terms"); the softmax on the f32 units
        flops_tc = b * hq * pairs * 6.0 * tile * hd
        tc_rate = hw.tensor_flops
    elif itemsize == 4:
        # 3xTF32 over the instance's head dim (its zero columns too): each
        # product three TF32 ones, so a third of the TF32 rate
        flops_tc = b * hq * pairs * 4.0 * tile * mma_instance(hd)
        tc_rate = hw.tf32_flops / 3
    else:
        # bf16 mma.sync, P.V with P as two terms as in the sm90 kernel
        flops_tc = b * hq * pairs * 6.0 * tile * mma_instance(hd)
        tc_rate = hw.tensor_flops
    flops_fp32 = b * hq * pairs * 8.0 * tile
    # Q read and O written once; each q block re-reads its K/V tiles
    hbm = (2 * b * hq * s * hd + b * hq * pairs * 2 * min(bkv, t) * hd) \
        * itemsize
    compute_s = flops_tc / tc_rate + flops_fp32 / hw.fp32_flops
    smem = variant_smem_bytes("flash_attention", variant, shape) or 0
    fill = _fill(b * hq * nq, variant, smem, hw)
    roof = max(compute_s, hbm / hw.hbm_bw)
    time = roof / (eff * fill) + hw.launch_s
    return VariantCost(time, flops_tc + flops_fp32, hbm, 1)


def rmsnorm_cost(variant: KernelVariant, shape: Mapping[str, int],
                 dtype: torch.dtype, params: Mapping[str, Any],
                 hw: HardwareModel = DEFAULT_HW, eff: float = 1.0
                 ) -> VariantCost:
    """Price one rmsnorm variant at one concrete shape (n rows × d)."""
    n, d = shape["n"], shape["d"]
    itemsize = dtype.itemsize
    flops = 4.0 * n * d
    if variant.route == "ref":
        # unfused f32 passes over the (n, d) activation (ref.py): the
        # casts, x*x, the mean, x*rsqrt, *(1+scale); 40 bytes per element
        # moved in bf16, 28 in f32
        hbm = (40 if itemsize != 4 else 28) * n * d
        launches = 10 if itemsize != 4 else 7
        work = (flops / hw.fp32_flops + hbm / hw.hbm_bw) / eff
        time = work + launches * hw.launch_s
        return VariantCost(time, flops, hbm, launches)
    # x read once, the output written once; the grid is the row groups of
    # the geometry at d (``rows_per_cta`` rows a CTA; one on the loop path)
    hbm = (2 * n * d + d) * itemsize
    roof = max(flops / hw.fp32_flops, hbm / hw.hbm_bw)
    geo = rmsnorm_geometry(d, dtype)
    fill = _fill(_ceil_div(n, geo.rows_per_cta), variant, geo.smem_bytes, hw)
    time = roof / (eff * fill) + hw.launch_s
    return VariantCost(time, flops, hbm, 1)


# ---------------------------------------------------------------------------
# calibration: each variant's distance from its modelled roofline
# ---------------------------------------------------------------------------

_LLAMA_8x1024_FLASH = {"b": 8, "hq": 32, "hkv": 32, "s": 1024, "t": 1024,
                       "hd": 128}
_LLAMA_8x1024_NORM = {"n": 8192, "d": 4096}
# the dense family's smoke heads at hd 16 at the (8, 1024) request: the
# mma kernel's bf16 variant runs only where the sm90 kernel has no
# instance, so it is calibrated there
_HD16_8x1024_FLASH = {"b": 8, "hq": 4, "hkv": 2, "s": 1024, "t": 1024,
                      "hd": 16}
# variant -> (shape, dtype, measured seconds): PERF.md §6, the kernel table
# of PR 13 (chip_smoke.py R5 on an H100 80GB HBM3 at 700 W: CUDA-event
# means of 20 launches after 3 warm-ups at llama2_1b (b, s) = (8, 1024),
# q/k/v (8, 32, 1024, 128) in the model layout, RMSNorm over 8192 x 4096;
# the mma kernel's rows: PERF.md §6, the device time of a launch,
# chip_smoke.py's ``device_ms`` in phase 14 (a) on the same card: at hd
# 16 a call's CUDA-event time, 0.0423 ms, holds the Python wrapper's host
# time, which ``hw.launch_s`` does not model; the RMSNorm kernel's row:
# PERF.md §6, its device time from torch.profiler's kernel records of
# back-to-back calls over inputs rotated across twice the L2,
# chip_smoke.py phase 2's sweep on the same card)
CALIBRATION: Dict[str, Tuple[Dict[str, int], torch.dtype, float]] = {
    SM90.name: (_LLAMA_8x1024_FLASH, torch.bfloat16, 0.2716e-3),  # ms col.
    MMA_F32.name: (_LLAMA_8x1024_FLASH, torch.float32, 1.4720e-3),  # device
    MMA_BF16.name: (_HD16_8x1024_FLASH, torch.bfloat16, 0.0320e-3),  # device
    REF_DENSE.name: (_LLAMA_8x1024_FLASH, torch.bfloat16, 5.3987e-3),  # plain
    REG_ROWS.name: (_LLAMA_8x1024_NORM, torch.bfloat16, 0.0472e-3),  # device
    REF_UNFUSED.name: (_LLAMA_8x1024_NORM, torch.bfloat16, 0.5538e-3),  # plain
}
# (the sm90 kernel's hd-256 instance, 64-key tiles, is priced with the
# efficiency of this hd-128 row, and every mma instance with its
# variant's row)
_EFF_CACHE: Dict[Tuple[str, HardwareModel], float] = {}


def efficiency(prim_name: str, variant: KernelVariant,
               hw: HardwareModel = DEFAULT_HW) -> float:
    """Modelled / measured time at the variant's calibration row, launch
    cost excluded: the share of its modelled roofline it reaches."""
    key = (variant.name, hw)
    eff = _EFF_CACHE.get(key)
    if eff is None:
        shape, dtype, measured = CALIBRATION[variant.name]
        raw = _REGISTRY[prim_name]["cost"](variant, shape, dtype,
                                           {"causal": True}, hw, 1.0)
        work = raw.time_s - raw.launches * hw.launch_s
        eff = work / (measured - raw.launches * hw.launch_s)
        _EFF_CACHE[key] = eff
    return eff


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# registry key -> variants, the default for a dtype, the cost function
_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_kernel(prim_name: str, variants: Sequence[KernelVariant],
                    default_for: Callable[[torch.dtype, Mapping[str, Any]],
                                          KernelVariant],
                    cost_fn: Callable[..., VariantCost]) -> None:
    _REGISTRY[prim_name] = dict(variants=tuple(variants),
                                default_for=default_for, cost=cost_fn)


def variants_for(prim_name: str) -> Tuple[KernelVariant, ...]:
    return _REGISTRY[prim_name]["variants"]


def default_variant(prim_name: str, dtype: torch.dtype,
                    shape: Optional[Mapping[str, Any]] = None
                    ) -> KernelVariant:
    """The variant the op's ``impl=None`` rule runs on a card for
    ``dtype`` (and, for flash attention, the head dim in ``shape``; none
    given: a head dim of the sm90 kernel) — the plain version for a dtype
    no kernel takes."""
    return _REGISTRY[prim_name]["default_for"](dtype, shape or {})


def registered_kernels() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def variant_cost(prim_name: str, variant: KernelVariant,
                 shape: Mapping[str, int], dtype: torch.dtype,
                 params: Mapping[str, Any],
                 hw: HardwareModel = DEFAULT_HW) -> VariantCost:
    """The calibrated model's price of one variant at one shape."""
    return _REGISTRY[prim_name]["cost"](variant, shape, dtype, params, hw,
                                        efficiency(prim_name, variant, hw))


def _flash_default(dtype: torch.dtype, shape: Mapping[str, Any]
                   ) -> KernelVariant:
    """``flash_attention.route_of`` as a variant."""
    if dtype == torch.bfloat16:
        return SM90 if route_of(dtype, shape.get("hd", HEAD_DIMS[0])) \
            == "sm90" else MMA_BF16
    return MMA_F32 if dtype == torch.float32 else REF_DENSE


register_kernel("flash_attention", FLASH_VARIANTS, _flash_default, flash_cost)
register_kernel(
    "rmsnorm", RMSNORM_VARIANTS,
    lambda dt, _shape: REG_ROWS if REG_ROWS.takes(dt) else REF_UNFUSED,
    rmsnorm_cost)


# ---------------------------------------------------------------------------
# shape extraction: kernel node dims -> the labels the cost model prices
# ---------------------------------------------------------------------------


def kernel_key(node) -> Optional[str]:
    """The registry key of a captured kernel node (``None``: not one)."""
    return PRIM_KEYS.get(node.prim_name)


def _node_dim_exprs(prim_name: str, node) -> Dict[str, Any]:
    """Map a kernel node's input dim exprs to cost-model labels."""
    if prim_name == "flash_attention":
        q, k = node.invals[0], node.invals[1]
        b, hq, s, hd = q.dims
        return {"b": b, "hq": hq, "hkv": k.dims[1], "s": s, "t": k.dims[2],
                "hd": hd}
    if prim_name == "rmsnorm":
        x = node.invals[0]
        lead, d = x.dims[:-1], x.dims[-1]
        n = None
        for e in lead:
            n = e if n is None else n * e
        return {"n": n if n is not None else 1, "d": d}
    raise KeyError(prim_name)


def _expr_bounds(expr, sg) -> Tuple[int, Optional[int]]:
    """(lo, hi) of one dim expression under the plan's shape graph."""
    if isinstance(expr, int):
        return expr, expr
    iv = sg.interval_of(expr)
    lo = iv.lo if iv.lo is not None and iv.lo >= 1 else 1
    return lo, iv.hi


def _probe_shapes(bounds: Mapping[str, Tuple[int, Optional[int]]]
                  ) -> List[Dict[str, int]]:
    """lo / geometric-mid / hi pricing corners (deduplicated)."""
    los = {k: lo for k, (lo, _hi) in bounds.items()}
    his = {k: hi if hi is not None else max(lo, _UNBOUNDED_PROBE)
           for k, (lo, hi) in bounds.items()}
    mids = {k: max(1, int(math.isqrt(los[k] * his[k]))) for k in bounds}
    probes, seen = [], set()
    for p in (los, mids, his):
        key = tuple(sorted(p.items()))
        if key not in seen:
            seen.add(key)
            probes.append(dict(p))
    return probes


def node_params(node) -> Dict[str, Any]:
    """The non-tensor arguments of a kernel node's call, by schema name
    (schema defaults filled in): ``causal``, ``softmax_scale``, ``impl``…"""
    from torch.utils import _pytree as pytree

    from ..core.ir.capture import Arg
    args, kwargs = pytree.tree_unflatten(list(node.params["leaves"]),
                                         node.params["spec"])
    out: Dict[str, Any] = {}
    for i, a in enumerate(node.prim._schema.arguments):
        if i < len(args) and not a.kwarg_only:
            val = args[i]
        elif a.name in kwargs:
            val = kwargs[a.name]
        elif a.has_default_value():
            val = a.default_value
        else:
            continue
        if not isinstance(val, Arg):
            out[a.name] = val
    return out


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def select_variant(prim_name: str,
                   bounds: Mapping[str, Tuple[int, Optional[int]]],
                   dtype: torch.dtype, params: Mapping[str, Any],
                   hw: HardwareModel = DEFAULT_HW,
                   forced: Optional[str] = None
                   ) -> Tuple[KernelVariant, Dict[str, float],
                              List[Dict[str, int]], Dict[str, str]]:
    """Pick the cheapest valid variant over one shape range.

    Returns ``(variant, scores, probes, invalid)``; ``invalid`` maps each
    ruled-out variant to the reason.  Validity is judged at the range's hi
    corner (``None`` = unbounded); scores sum the model time over the
    lo/mid/hi pricing corners.  ``forced`` pins a variant by name
    (measured re-selection) — it must still be valid.  Raises
    ``ValueError`` when no variant is valid (a dtype or head dim no kernel
    takes, over a range where the plain version's transients are
    unbounded or too large)."""
    entry = _REGISTRY[prim_name]
    hi_shape = {k: hi for k, (_lo, hi) in bounds.items()}
    probes = _probe_shapes(bounds)
    scores: Dict[str, float] = {}
    invalid: Dict[str, str] = {}
    valid: List[KernelVariant] = []
    for v in entry["variants"]:
        why = variant_invalid_reason(prim_name, v, hi_shape, dtype, hw)
        if why is not None:
            invalid[v.name] = why
            continue
        valid.append(v)
        scores[v.name] = sum(
            variant_cost(prim_name, v, p, dtype, params, hw).time_s
            for p in probes)
    if not valid:
        raise ValueError(
            f"no valid {prim_name} variant for {dtype} over bounds "
            f"{dict(bounds)}: {invalid}")
    if forced is not None:
        chosen = next((v for v in valid if v.name == forced), None)
        if chosen is None:
            raise ValueError(
                f"forced variant {forced!r} is not valid for {prim_name} "
                f"over bounds {dict(bounds)} (valid: "
                f"{[v.name for v in valid]}; invalid: {invalid})")
        return chosen, scores, probes, invalid
    default = entry["default_for"](dtype, hi_shape)
    best = min(valid, key=lambda v: (scores[v.name],
                                     v.name != default.name, v.name))
    return best, scores, probes, invalid


def node_bounds(node, sg) -> Dict[str, Tuple[int, Optional[int]]]:
    """A kernel node's cost-model dim bounds under one shape graph."""
    exprs = _node_dim_exprs(kernel_key(node), node)
    return {k: _expr_bounds(e, sg) for k, e in exprs.items()}


def select_for_node(node, sg, hw: HardwareModel = DEFAULT_HW,
                    forced: Optional[str] = None) -> KernelSelection:
    """Select a variant for one kernel node under a plan's shape graph."""
    prim_name = kernel_key(node)
    bounds = node_bounds(node, sg)
    dtype = node.invals[0].dtype
    variant, scores, probes, invalid = select_variant(
        prim_name, bounds, dtype, node_params(node), hw, forced=forced)
    return KernelSelection(node_id=node.id, prim_name=prim_name,
                           variant=variant,
                           default=default_variant(
                               prim_name, dtype,
                               {k: h for k, (_lo, h) in bounds.items()}),
                           scores=scores, bounds=bounds, probes=probes,
                           invalid=invalid, measured=forced is not None)


def select_kernels(graph, sg, hw: HardwareModel = DEFAULT_HW,
                   forced: Optional[Mapping[int, str]] = None,
                   decisions=None) -> Dict[int, KernelSelection]:
    """Select a variant for every kernel node in ``graph`` — including a
    node whose call passed an explicit ``impl``, as the reference does: a
    plan that must run the plain version is built with
    ``kernel_select=False``.

    ``forced`` maps node id -> variant name (the measured-fallback path).
    Returns node id -> :class:`KernelSelection`; logs one ``kernel-select``
    decision per node when a ``DecisionLog`` is given (the times are the
    Hopper model's)."""
    out: Dict[int, KernelSelection] = {}
    for node in graph.nodes:
        if kernel_key(node) is None:
            continue
        sel = select_for_node(node, sg, hw,
                              forced=(forced or {}).get(node.id))
        out[node.id] = sel
        if decisions is not None:
            sel_us = sel.scores.get(sel.variant.name, 0.0) * 1e6
            def_us = sel.scores.get(sel.default.name, sel_us) * 1e6
            why = (f"measured re-selection over {sel.describe_bounds()}"
                   if sel.measured else
                   f"model {sel_us:.1f}us vs default {def_us:.1f}us "
                   f"over {sel.describe_bounds()}")
            hi = {k: h for k, (_lo, h) in sel.bounds.items()}
            decisions.add("kernel-select", f"%{node.id} {sel.prim_name}",
                          sel.variant.name, why,
                          block=variant_block(sel.variant, hi),
                          model_speedup=round(sel.model_speedup, 3),
                          n_scored=len(sel.scores),
                          invalid=list(sel.invalid))
    return out


def select_eager(prim_name: str, shape: Mapping[str, int],
                 dtype: torch.dtype, params: Mapping[str, Any],
                 hw: HardwareModel = DEFAULT_HW) -> KernelVariant:
    """Cost-model choice at one *concrete* shape.  (The ops' ``impl=None``
    keeps its dtype rule; this answers what the model would pick.)"""
    bounds = {k: (int(v), int(v)) for k, v in shape.items()}
    variant, _scores, _probes, _invalid = select_variant(
        prim_name, bounds, dtype, params, hw)
    return variant


# ---------------------------------------------------------------------------
# measured fallback: time the candidates at a representative shape
# ---------------------------------------------------------------------------


def node_shape(node, env: Mapping[str, int]) -> Dict[str, int]:
    """A kernel node's cost-model labels at one concrete dim binding."""
    exprs = _node_dim_exprs(kernel_key(node), node)
    return {k: int(e) if isinstance(e, int) else int(e.evaluate(dict(env)))
            for k, e in exprs.items()}


def measure_variants(prim_name: str, node, env: Mapping[str, int],
                     hw: HardwareModel = DEFAULT_HW, repeats: int = 3, *,
                     device: Any = "cuda", seed: int = 0
                     ) -> Dict[str, float]:
    """Time every variant of ``node`` that is valid at ``env``.

    Inputs at the node's concrete shapes come from a ``torch.Generator``
    seeded with ``seed`` (values are irrelevant to timing).  Each variant
    runs once to warm up (on a card: builds the kernels), then the best
    of ``repeats`` calls is kept: timed with CUDA events on a card, with
    ``perf_counter`` on the CPU (where every variant is the plain
    version).  Returns variant name -> seconds."""
    import time as _time

    from torch.utils import _pytree as pytree

    from ..core.ir.capture import Arg, override_template, resolve_leaves

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tensors = []
    for v in node.invals[:node.n_args]:
        shape = tuple(int(d.evaluate(dict(env))) for d in v.dims)
        tensors.append(torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float32).to(v.dtype))
    dtype = node.invals[0].dtype
    hi_shape = node_shape(node, env)
    cuda = dev.type == "cuda"
    timings: Dict[str, float] = {}
    for variant in variants_for(prim_name):
        if not variant_valid(prim_name, variant, hi_shape, dtype, hw):
            continue
        leaves, spec = override_template(node, variant.overrides())
        leaves = resolve_leaves(leaves, env)
        leaves = [tensors[x.i] if isinstance(x, Arg) else x for x in leaves]
        args, kwargs = pytree.tree_unflatten(leaves, spec)

        def run():
            return node.prim(*args, **kwargs)

        run()                                   # warm-up (and build)
        best = float("inf")
        for _ in range(max(1, repeats)):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) * 1e-3)
            else:
                t0 = _time.perf_counter()
                run()
                best = min(best, _time.perf_counter() - t0)
        timings[variant.name] = best
    return timings
