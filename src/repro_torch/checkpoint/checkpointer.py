"""Fault-tolerant checkpointing with elastic (re-shardable) restore.

Port of ``repro/checkpoint/checkpointer.py``:

  * **atomic**: write to a temp dir, then rename — a crash mid-save never
    corrupts the latest checkpoint;
  * **async**: saves run on a background thread off the training loop;
    a failed save raises at the next ``wait()`` (or ``save()``);
  * **keep-N** garbage collection;
  * **data-pipeline cursor** and optimizer step are saved alongside
    (``extra``), giving exact-once resume semantics;
  * **elastic restore**: leaves are stored as full logical tensors (a
    DTensor leaf is gathered whole before it is written), so a checkpoint
    restores onto any mesh: ``restore(shardings=...)`` makes each leaf a
    DTensor with its ``NamedSharding`` (``launch.sharding``), each rank
    cutting its own shard from the full tensor it read, as each host does
    in the reference; nothing is scattered.

``save`` copies every leaf to host memory before it returns, so a trainer
may donate the state to its next step while the write is in flight.
Leaves are stored as ``.npy`` files; a bfloat16 leaf (which numpy cannot
hold) is stored as its int16 bits, its dtype named in ``meta.json``, and
restored bit for bit.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.api import resolve_device

# dtypes numpy has no type for: stored as integer bits of the same width
_BITS = {torch.bfloat16: torch.int16}


def _key_name(k: Any) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _flatten_with_names(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    flat, spec = pytree.tree_flatten_with_path(tree)
    return [("/".join(_key_name(k) for k in path), leaf)
            for path, leaf in flat], spec


def _to_host(x: Any) -> torch.Tensor:
    """A host copy that no later write to ``x`` (or its donation) reaches."""
    if hasattr(x, "full_tensor"):          # a DTensor: its logical tensor
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # per finished save: step, bytes written, seconds to snapshot to
        # the host (on the caller's thread) and to write
        self.saves: List[Dict[str, Any]] = []

    # -- save -------------------------------------------------------------------
    def save(self, step: int, state: Any, *, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Snapshot ``state`` (pytree of tensors) at ``step``."""
        t0 = time.perf_counter()
        leaves, spec = _flatten_with_names(state)
        host = [(n, _to_host(x)) for n, x in leaves]
        snapshot_s = time.perf_counter() - t0
        extra = dict(extra or {})

        def _write():
            t1 = time.perf_counter()
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
            try:
                dtypes, nbytes = [], 0
                for name, t in host:
                    bits = _BITS.get(t.dtype)
                    arr = (t.view(bits) if bits is not None else t).numpy()
                    np.save(os.path.join(tmp, name.replace("/", "__")
                                         + ".npy"), arr)
                    dtypes.append(str(t.dtype).replace("torch.", ""))
                    nbytes += arr.nbytes
                meta = {
                    "step": step,
                    "names": [n for n, _ in host],
                    "dtypes": dtypes,
                    "treedef": str(spec),
                    "extra": extra,
                    "time": time.time(),
                }
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                # the tree's containers with each leaf's index in place of
                # the leaf: plain dicts, lists and named tuples pickle
                # across torch versions, a TreeSpec's internals may not
                with open(os.path.join(tmp, "treedef.pkl"), "wb") as f:
                    pickle.dump(pytree.tree_unflatten(
                        list(range(len(host))), spec), f)
                final = os.path.join(self.dir, f"step_{step:010d}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)  # atomic publish
                self._gc()
                self.saves.append(dict(step=step, bytes=nbytes,
                                       snapshot_s=snapshot_s,
                                       write_s=time.perf_counter() - t1))
            except BaseException as e:  # surfaced on next wait()
                self._error = e
                shutil.rmtree(tmp, ignore_errors=True)

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err}") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, device: Any = None,
                shardings: Any = None) -> Tuple[int, Any, Dict]:
        """Load ``(step, state, extra)``; the state's tensors on ``device``
        (``cuda`` unless given).  ``shardings``: a pytree of
        ``NamedSharding`` (or ``None``) leaves laid out as the state; each
        leaf with a sharding becomes a DTensor on its mesh (on the mesh's
        device), the rank's shard cut from the full tensor, the rest stay
        plain tensors."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(d, "treedef.pkl"), "rb") as f:
            skeleton = pickle.load(f)
        leaves = []
        for name, dt in zip(meta["names"], meta["dtypes"]):
            arr = np.load(os.path.join(d, name.replace("/", "__") + ".npy"))
            t = torch.from_numpy(arr)
            dtype = getattr(torch, dt)
            if dtype in _BITS:
                t = t.view(dtype)
            leaves.append(t.to(dev))
        state = pytree.tree_map(leaves.__getitem__, skeleton)
        if shardings is not None:
            state = pytree.tree_map(_distribute, state, shardings)
        return meta["step"], state, meta.get("extra", {})


def _distribute(x: Any, sharding: Any) -> Any:
    """``x`` as a DTensor with ``sharding``'s placements on its mesh, this
    rank's shard cut locally (``src_data_rank=None``: no collective)."""
    if sharding is None:
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x.to(sharding.mesh.device_type), sharding.mesh,
                             sharding.placements, src_data_rank=None)
