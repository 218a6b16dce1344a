"""The dry-run against a real reference lowering: smoke ``llama2_1b``.

One subprocess runs the reference with ``XLA_FLAGS`` forcing 8 host
devices: it lowers and compiles the smoke config at ``train_4k`` and
``decode_32k`` on a 2x4 ``(data, model)`` mesh with the reference's own
``ShardingRules``, ``input_specs`` and steps (``jax.jit`` with its
``donate_argnums``), and reads ``memory_analysis()``, ``HLOAnalyzer``'s
FLOPs and the HLO's collective bytes.  The port runs the same cells with
``launch.dryrun.run_cell`` as rank 0 of a fake 8-rank world on a 2x4 mesh.
Both train steps take ``grad_accum=2`` (the port unrolls its
micro-batches, so 8 of them cost a minute of capture here; the counts per
device do not depend on it).

* ``argument_bytes`` equals ``argument_size_in_bytes`` exactly;
* per-device FLOPs agree within 1e-6 once the terms each side counts by
  design are added (:func:`named_terms`);
* the collective bytes of each type are printed side by side, and every
  type the reference's HLO holds is > 0 in the port, except those the
  port does not emit in the cell (:func:`not_emitted`):
  ``collective-permute`` (DTensor has no point-to-point redistribution)
  anywhere, and ``all-to-all`` in the dense cells.  The port's own
  all-to-alls (``strategies._all_to_all``, where DTensor's CPU world
  would all-gather and chunk) are an MoE layer's dispatch onto the
  expert shard and its combine back, and in a product that moves its
  rows (a decode step's, ``strategies._rows_move``) the rows onto the
  weight's contraction shard and the output's columns back onto its
  rows.  The dense train cells move no rows (a gradient is taken), so
  their all-to-all stays 0 where the reference's XLA emits some; their
  FLOPs, argument bytes and collectives are held to the counts they had
  before rows could move, each block recomputed in the backward as in
  the reference's lowering (``TRAIN_BEFORE``);
* ``decode_32k`` keeps the cache where ``cache_specs`` puts it, on its
  32k positions over the model axis, as the reference's XLA does: the
  all-gather bytes stay below 1% of the argument bytes (what is left are
  the weights' gathers), no collective output is as large as one layer's
  local k shard, and the temp bytes stay below the argument bytes.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import _mesh, destroy_world, init_fake_world
from repro_torch.launch.sharding import ShardingRules
from test_torch_dryrun_decode import local_cache_leaf_bytes

CELLS = ["train_4k", "decode_32k"]
GRAD_ACCUM = 2
DECODE_GATHER = 0.01      # decode all-gather bytes over the argument bytes
REF_SCRIPT = r"""
import json, os, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.launch.hlo_analysis import HLOAnalyzer
from repro.launch.sharding import ShardingRules
from repro.launch.specs import input_specs
from repro.launch.steps import (make_prefill_step, make_serve_step,
                                make_train_step)
devs = jax.devices()
assert len(devs) == 8, devs
from repro.launch.dryrun import collective_bytes   # sets XLA_FLAGS: late
arch, grad_accum = sys.argv[1], int(sys.argv[2])
cfg = get_smoke_config(arch)
mesh = Mesh(np.array(devs).reshape(2, 4), ("data", "model"))
rules = ShardingRules(mesh)
out = {}
for shape in sys.argv[3:]:
    kind, specs = input_specs(cfg, shape)
    def shard(tree, fn):
        sh = rules.named(fn(tree))
        return jax.tree.map(lambda s, ns: jax.ShapeDtypeStruct(
            s.shape, s.dtype, sharding=ns), tree, sh)
    with mesh:
        if kind == "train":
            args = (shard(specs["params"], rules.params_pspecs),
                    shard(specs["opt_state"], rules.params_pspecs),
                    shard(specs["batch"], rules.batch_specs))
            jfn = jax.jit(make_train_step(cfg, grad_accum=grad_accum),
                          donate_argnums=(0, 1))
        elif kind == "prefill":
            args = (shard(specs["params"], rules.params_pspecs),
                    shard(specs["batch"], rules.batch_specs))
            jfn = jax.jit(make_prefill_step(cfg))
        else:
            args = (shard(specs["params"], rules.params_pspecs),
                    shard(specs["state"], rules.cache_specs),
                    shard(specs["inp"], rules.batch_specs))
            jfn = jax.jit(make_serve_step(cfg), donate_argnums=(1,))
        comp = jfn.lower(*args).compile()
    hlo = comp.as_text()
    out[shape] = {
        "argument_bytes": int(comp.memory_analysis().argument_size_in_bytes),
        "flops": HLOAnalyzer(hlo).analyze()["flops"],
        "collectives": collective_bytes(hlo)}
print("REF " + json.dumps(out))
"""
# the dense train cells' (FLOPs, argument bytes, collectives by type in
# COLLECTIVES' order) as before a product could move its rows (torch
# 2.13), with each block recomputed in the backward (remat_policy
# "block", as the reference's lowering).  Against the flat graph's
# counts (llama2_1b 4,521,526,820,864 FLOPs, all-gather 296,730,624,
# reduce-scatter 406,704,128; gemma_2b 2,007,897,210,880 and 1,158,733,824)
# the FLOPs rose by the recompute, each layer's forward but its last FFN
# product (the reference's own, so no named term remains); the all-gather
# by every weight gathered again in the recompute, as the reference's
# remat gathers it again (llama2_1b +8,830,976), and in gemma_2b by the
# flash rule's head gather (one kv head on a model axis of 4) repeated
# (+403,611,648); llama2_1b's reduce-scatter by one more of the first
# block's input a micro-batch (+67,108,864), which the block redistributes
# on entry and so again in its recompute.  Argument bytes, all-reduce and
# gemma_2b's reduce-scatter are unchanged.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
TRAIN_BEFORE = {
    "llama2_1b": (5_782_099_722_240, 5_787_140, (
        305_561_600, 1_074_518_032, 473_812_992, 0, 0)),
    "gemma_2b": (2_576_980_377_600, 4_382_468, (
        1_562_345_472, 268_631_056, 34_045_952, 0, 0))}


def not_emitted(cfg) -> tuple:
    """The collective types the port does not emit in ``cfg``'s cells (see
    the module docstring)."""
    return ("collective-permute",) + (() if cfg.n_experts else
                                      ("all-to-all",))


def named_terms(cfg, shape, model: int, data: int) -> dict:
    """Per-device FLOPs each side counts by design, by name.

    Both sides recompute each layer's forward in the backward but the last
    FFN product (``remat_policy="block"``: the reference's layer scan under
    ``jax.checkpoint``, the port's blocks under ``torch.utils.checkpoint``),
    so that needs no term.

    * ``reference blockwise delta``: past T = 2048 the reference's
      blockwise backward contracts dO with O over hd once a layer
      (``delta``), 2·Hq·hd a token.
    * ``reference router repeat``: the MoE router's product (D x E, E
      whole) on every model rank of a data rank's tokens.  The port's
      activations there are sharded on the batch over the model axis
      too (the flash rule's choice where the model axis does not divide
      the kv heads, and MLA's), so each rank routes its own tokens;
      2·D·E a token and layer, times (model - 1) / (data · model) of the
      cell's tokens.  Counted for the forward-only cells (prefill,
      decode).
    The port's flash backward recomputes QKᵀ as the reference's blockwise
    one does past T = 2048, so that needs no term here; and it runs on
    the shards the forward ran on (``strategies._LocalFlash``), so where
    the model axis does not divide the kv heads no rank computes a kv
    weight gradient whole."""
    cell = SHAPES[shape]
    if cell["kind"] != "train":
        if not cfg.n_experts:
            return {}
        tokens = cell["global_batch"] * (
            cell["seq_len"] if cell["kind"] == "prefill" else 1)
        return {"reference router repeat":
                -cfg.n_layers * 2 * cfg.d_model * cfg.n_experts * tokens *
                (model - 1) // (data * model)}
    hq, hd, n = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    t = cell["seq_len"]
    per_device = cell["global_batch"] * t // (model * data)
    return {"reference blockwise delta":
            -(n * 2 * hq * hd * per_device if t > 2048 else 0)}


def compare(arch, cells=CELLS):
    """Both sides' records of ``cells``, printed side by side, and the
    checks."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, arch, str(GRAD_ACCUM)] + cells,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cfg = get_smoke_config(arch)
    ours = {}
    init_fake_world(8)
    try:
        mesh = _mesh((2, 4), ("data", "model"), torch.device("cpu"))
        k_shard = local_cache_leaf_bytes(cfg, "decode_32k",
                                         ShardingRules(mesh))
        get = dryrun.get_config
        dryrun.get_config = get_smoke_config
        try:
            for shape in cells:
                ours[shape] = dryrun.run_cell(arch, shape, multi_pod=False,
                                              grad_accum=GRAD_ACCUM,
                                              mesh=mesh)
        finally:
            dryrun.get_config = get
    finally:
        destroy_world()
    out, err = ref_proc.communicate(timeout=600)
    assert ref_proc.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("REF "))
    ref = json.loads(line[4:])
    for shape in cells:
        rec, want = ours[shape], ref[shape]
        assert rec["status"] == "ok" and rec["mesh"] == "2x4"
        assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                      "temp_bytes", "total_per_device_bytes"}
        assert rec["memory"]["argument_bytes"] == want["argument_bytes"]
        terms = named_terms(cfg, shape, model=4, data=2)
        got = rec["flops"] - sum(terms.values())
        print(f"{arch} {shape}: flops port {rec['flops']:.0f} reference "
              f"{want['flops']:.0f} named terms {terms}")
        assert abs(got - want["flops"]) <= 1e-6 * want["flops"], \
            (shape, got, want["flops"])
        for c, b in want["collectives"].items():
            print(f"  {c:18s} port {rec['collectives'][c]:>14,} "
                  f"reference {b:>14,}")
            if b > 0 and c not in not_emitted(cfg) and c != "total":
                assert rec["collectives"][c] > 0, (shape, c)
        if SHAPES[shape]["kind"] == "train" and arch in TRAIN_BEFORE:
            assert (rec["flops"], rec["memory"]["argument_bytes"],
                    tuple(rec["collectives"][c] for c in COLLECTIVES)) == \
                TRAIN_BEFORE[arch], rec["collectives"]
        if SHAPES[shape]["kind"] == "decode":
            mem, largest = rec["memory"], rec["collectives_largest"]
            print(f"  largest collective {largest}, one layer's local k "
                  f"shard {k_shard}, temp {mem['temp_bytes']}, arguments "
                  f"{mem['argument_bytes']}")
            assert rec["collectives"]["all-gather"] < \
                DECODE_GATHER * mem["argument_bytes"], rec["collectives"]
            assert max(largest.values()) < k_shard, largest
            assert mem["temp_bytes"] < mem["argument_bytes"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_llama2_1b_cells_against_the_reference_lowering():
    compare("llama2_1b")
