"""Train a reduced model for a few hundred steps with fault tolerance (the
twin of ``examples/train_small.py``).

    python -m repro_torch.examples.train_small [--arch qwen2.5-3b] [--steps 200] [--device cpu]

Exercises the training substrate of the port: AdamW, remat, atomic
checkpoints (``CheckpointStore``, in a temporary directory removed at the
end) and ``FaultTolerantRunner``, with a NaN injected at ``steps // 2`` to
show rollback and resume. The smoke config of ``--arch``, weights from seed
0 on ``--device`` (the GPU unless ``cpu``), the reference's synthetic
next-token stream.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import registry
from repro_torch.distributed.fault import FaultPolicy, FaultTolerantRunner
from repro_torch.launch.train import synthetic_batches
from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = registry.get_smoke(args.arch)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    losses = []

    def wrapped(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        loss = float(m["loss"].item())
        losses.append(loss)
        if len(losses) % 25 == 1:
            print(f"  step {len(losses):4d}  loss {loss:.4f}")
        return (p, o), {"loss": loss}

    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        runner = FaultTolerantRunner(
            wrapped, CheckpointStore(ckpt, keep_last=2),
            FaultPolicy(checkpoint_every=50),
        )
        runner.inject(args.steps // 2, "nan")  # demo: mid-run failure
        state, done, events = runner.run(
            (params, opt), synthetic_batches(cfg, 8, 48, device), args.steps
        )
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"completed {done} steps; injected faults handled: "
          f"{[(e.step, e.kind) for e in events]}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'OK: decreased' if losses[-1] < losses[0] else 'WARNING'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
