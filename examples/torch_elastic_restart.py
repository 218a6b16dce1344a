"""Fault-tolerance demo on the PyTorch port: kill a serving worker
mid-stream, restore from its checkpoint, and resume with bit-identical
outputs (the twin of ``examples/elastic_restart.py``).

A worker serves a deterministic stream of training requests through the
hardened ``BucketBatcher`` loop (structured ``RequestFailed`` outcomes,
no crash-on-failure), checkpointing its state every few requests via the
atomic :class:`~repro_torch.checkpoint.Checkpointer`.  We then "lose" the
worker mid-serve, bring up a fresh one from the latest checkpoint, and
replay the remainder of the stream: the combined loss sequence and the
final parameters match an uninterrupted run bitwise -- exact-once resume.

The coda restores the same checkpoint onto a device mesh through
``ShardingRules``: checkpoints store full logical tensors, so they
re-shard onto any topology (each leaf a DTensor, each rank cutting its
own shard), which is what makes the restart *elastic*.

    PYTHONPATH=src python examples/torch_elastic_restart.py
    PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu
"""
import argparse
import tempfile

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import TensorSpec, optimize, spec_like, symbolic_dims
from repro_torch.core.api import resolve_device
from repro_torch.core.resilience import ResilienceConfig
from repro_torch.launch.serve import BucketBatcher

B, S = symbolic_dims("b, s")
V, D, FF = 300, 32, 64


def loss_fn(params, tokens, labels):
    emb = F.embedding(tokens, params["emb"])
    h = F.gelu(emb @ params["w1"], approximate="tanh")   # jax.nn.gelu
    logits = (h @ params["w2"]) @ params["emb"].T
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


def train_step(params, tokens, labels):
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = loss_fn(leaves, tokens, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: p - 1e-3 * g
                           for (k, p), g in zip(params.items(), grads)}


def init_params(device, seed=0):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in (("emb", rng.randn(V, D)),
                         ("w1", rng.randn(D, FF) * 0.05),
                         ("w2", rng.randn(FF, D) * 0.05))}


def tokens_of(b, s, seed, device):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, V, (b, s)).astype(np.int32)) \
        .to(device)


def request_stream(n=10):
    """Deterministic shape-diverse request stream: (b, s, data seed)."""
    shapes = [(2, 24), (3, 48), (2, 16), (4, 40)]
    return [shapes[i % len(shapes)] + (i,) for i in range(n)]


def make_worker(device):
    """A fresh serving worker -- what a restarted process would build.

    ``kernel_select=False`` keeps the compiled pipeline fully
    deterministic across restarts (measured selection could legitimately
    pick a different variant on the new host)."""
    f32 = torch.float32
    return optimize(train_step,
                    {"emb": TensorSpec((V, D), f32),
                     "w1": TensorSpec((D, FF), f32),
                     "w2": TensorSpec((FF, D), f32)},
                    TensorSpec((B, S), torch.int32),
                    TensorSpec((B, S), torch.int32),
                    dynamic_dims={"b": (1, 8), "s": (8, 256)},
                    buckets={"s": [32, 256]},
                    kernel_select=False,
                    resilience=ResilienceConfig(), device=device)


class WorkerKilled(RuntimeError):
    """The simulated mid-serve crash."""


def serve(requests, ck, params, device, *, start=0, ckpt_every=3,
          kill_at=None):
    """Serve ``requests[start:]`` on a fresh worker, checkpointing state
    + cursor every ``ckpt_every`` requests.  ``kill_at`` crashes the
    worker before that request is processed (the demo's fault).

    Returns ``(params, losses)`` where ``losses`` is ``[(request index,
    loss), ...]`` -- each request is processed exactly once.
    """
    bat = BucketBatcher(make_worker(device))
    losses = []
    for i in range(start, len(requests)):
        if kill_at is not None and i == kill_at:
            raise WorkerKilled(f"worker lost before request {i}")
        b, s, seed = requests[i]
        bat.submit({"b": b, "s": s},
                   payload=(params, tokens_of(b, s, seed, device),
                            tokens_of(b, s, seed + 1, device)))
        [outcome] = bat.process()
        if not outcome["ok"]:              # structured, not a crash
            print(f"request {i} failed structurally: {outcome['error']}")
            continue
        loss, params = outcome["value"]
        losses.append((i, loss.cpu()))
        if (i + 1) % ckpt_every == 0:
            ck.save(i + 1, {"params": params}, extra={"cursor": i + 1})
    return params, losses


def resume(requests, ck, device, **kw):
    """Restore the latest checkpoint and serve the rest of the stream."""
    cursor, state, extra = ck.restore(device=device)
    assert extra["cursor"] == cursor
    return serve(requests, ck, state["params"], device, start=cursor, **kw)


def elastic_restore(ck, device):
    """The latest checkpoint onto a 1x1 mesh through ``ShardingRules``:
    every leaf a DTensor whose local shard is the saved tensor, bit for
    bit.  Starts a one-process group if none exists, and destroys it."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import destroy_world, make_debug_mesh
    from repro_torch.launch.sharding import ShardingRules

    _, saved, _ = ck.restore(device=device)
    params = saved["params"]
    started = not dist.is_initialized()
    try:
        mesh = make_debug_mesh(1, 1, device=device)  # the "new" cluster
        rules = ShardingRules(mesh)
        shardings = {"params": rules.named(rules.params_pspecs(
            spec_like(params)))}
        step, state, _ = ck.restore(device=device, shardings=shardings)
        got = state["params"]
        assert all(isinstance(x, DTensor) for x in pytree.tree_leaves(got))
        assert all(torch.equal(got[k].to_local(), params[k]) for k in params)
        print(f"elastic restore at step {step}: params resharded onto "
              f"{mesh.size()}-device mesh OK ({dist.get_backend()})")
        return step
    finally:
        if started:
            destroy_world()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu: run on the CPU)")
    device = resolve_device(ap.parse_args(argv).device)
    requests = request_stream(10)
    with tempfile.TemporaryDirectory() as ref_dir, \
            tempfile.TemporaryDirectory() as d:
        # uninterrupted reference
        ref_params, ref_losses = serve(requests, Checkpointer(ref_dir),
                                       init_params(device), device)
        # the same stream, crashed at request 7 (checkpoint landed at 6)
        ck = Checkpointer(d)
        try:
            serve(requests, ck, init_params(device), device, kill_at=7)
        except WorkerKilled as e:
            print(f"crash: {e}")
        res_params, res_losses = resume(requests, ck, device)
        print(f"restored at cursor {ck.latest_step()}, replayed "
              f"{len(res_losses)} requests")

        # exact-once, bit-exact: the resumed tail matches the reference
        tail = dict(ref_losses)
        assert all(torch.equal(tail[i], l) for i, l in res_losses)
        assert all(torch.equal(ref_params[k], res_params[k])
                   for k in ref_params)
        print("resumed outputs match the uninterrupted run bitwise: True")

        # elastic restore onto a mesh: checkpoints store full logical
        # tensors, so they re-shard onto any device topology
        step = elastic_restore(ck, device)
    return {"restored_at": step, "replayed": len(res_losses)}


if __name__ == "__main__":
    main()
