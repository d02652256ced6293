"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [...]``
(the twin of ``repro.launch.train``).

    python -m repro_torch.launch.train --full             # olmo-1b, published size, GPU
    python -m repro_torch.launch.train --arch whisper-tiny --steps 10 --device cpu

The smoke config by default, the published config with ``--full``, on the
GPU unless ``--device cpu``; synthetic next-token data; AdamW; periodic
atomic checkpoints with auto-resume and rollback through
``FaultTolerantRunner``. Weights are random, from seed 0 on ``--device``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import registry
from repro_torch.distributed.fault import FaultPolicy, FaultTolerantRunner
from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import make_train_step


def synthetic_batches(cfg, batch: int, seq: int, device="cpu"):
    """Deterministic synthetic LM stream, the reference's: a shifted-token
    next-token task with copy structure (learnable, so a falling loss means
    something); audio adds the stub frontend's frames."""

    def get(step: int):
        rng = np.random.RandomState(step)
        toks = rng.randint(16, min(cfg.vocab_size, 4096), size=(batch, seq + 1))
        toks[:, 1::2] = toks[:, 0:-1:2]
        b = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device)}
        if cfg.family == "audio":
            fr = rng.randn(batch, cfg.encoder.num_frames, cfg.d_model)
            b["frames"] = torch.from_numpy(fr.astype(np.float32)).to(device)
        return b

    return get


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--full", action="store_true", help="the published config (GPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get(args.arch) if args.full else registry.get_smoke(args.arch)
    print(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M device={device}")
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)

    def wrapped(state, batch):
        params, opt_state = state
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        return (params, opt_state), {k: float(v.item()) for k, v in metrics.items()}

    store = CheckpointStore(args.ckpt_dir, keep_last=2)
    runner = FaultTolerantRunner(wrapped, store, FaultPolicy(checkpoint_every=args.ckpt_every))
    batches = synthetic_batches(cfg, args.batch, args.seq, device)

    t0 = time.perf_counter()
    losses = []

    def logged(state, b):
        s, m = wrapped(state, b)
        losses.append(m.get("loss", m.get("nll", 0.0)))
        if len(losses) % 10 == 1:
            print(f"[train] step={len(losses):4d} loss={losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)")
        return s, m

    runner.step_fn = logged
    _, completed, events = runner.run((params, opt_state), batches, args.steps)
    if not losses:
        print(f"[train] resumed at step {completed} from {args.ckpt_dir}: nothing to run")
        return 0
    print(f"[train] done: {completed} steps, first loss {losses[0]:.4f} -> "
          f"last {losses[-1]:.4f}, fault events: {len(events)}")
    if losses[-1] >= losses[0]:
        print("[train] WARNING: loss did not decrease")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
