"""End-to-end example on the PyTorch port: fine-tune the (reduced) Llama on
a CodeAlpaca-like variable-length stream with the BladeDISC++
dynamic-shape path, under a memory cap, with checkpointing — the paper's
§3 workload end to end (the twin of ``examples/train_dynamic_llama.py``).

    PYTHONPATH=src python examples/torch_train_dynamic_llama.py
    PYTHONPATH=src python examples/torch_train_dynamic_llama.py --device cpu
"""
import argparse
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu: run on the CPU)")
    args = ap.parse_args()
    cfg = get_smoke_config("llama2-1b")
    with tempfile.TemporaryDirectory() as d:
        # establish the free-run peak, then train under a 75% cap
        probe = train(cfg, steps=5, batch_size=6, mode="dynamic", log_every=2,
                      device=args.device)
        cap = int(probe["peak_bytes"] * 0.75)
        stats = train(cfg, steps=120, batch_size=6, mode="dynamic",
                      memory_limit=cap, ckpt_dir=d, ckpt_every=40,
                      log_every=20, device=args.device)
    print(f"tokens/s       : {stats['tokens_per_s']:.0f}")
    print(f"loss           : {stats['losses'][0]:.3f} -> "
          f"{stats['losses'][-1]:.3f}")
    print(f"peak bytes     : {stats['peak_bytes']/2**20:.1f} MiB "
          f"(cap {cap/2**20:.1f})")
    print(f"recompilations : {stats['recompilations']} "
          f"(dynamic shapes, one trace)")
    print(f"checkpoints    : {len(stats['checkpoints'])} saved, "
          f"{sum(c['bytes'] for c in stats['checkpoints'])} bytes")


if __name__ == "__main__":
    main()
