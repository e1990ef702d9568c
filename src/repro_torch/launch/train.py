"""End-to-end training driver of the port.

Config -> model and optimizer state on the device -> data pipeline ->
guarded train loop with straggler detection, async checkpointing and
crash recovery, as the reference's ``repro.launch.train``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-32b \
      --smoke --steps 20 --device cpu

runs on the card unless ``--device`` names another device (``--smoke``
for the reduced config).  Weights come from a ``torch.Generator`` seeded
0 on the device; batches are ``TokenDataset``'s.  Only a ``1x1`` mesh is
ported: data-parallel and "model"-axis training wait for the training
half of ``sharding/specs.py``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import init_model
from repro_torch.training import (
    AsyncCheckpointer,
    DataConfig,
    StepGuard,
    StragglerDetector,
    TokenDataset,
    latest_step,
    restore,
)
from repro_torch.training.train_step import init_train_state, make_train_step


def check_mesh(spec: str) -> None:
    d, m = (int(x) for x in spec.split("x"))
    if (d, m) != (1, 1):
        raise NotImplementedError(
            f"--mesh {spec}: data-parallel and 'model'-axis training are "
            "not ported to repro_torch (ROADMAP Queue 1 item 4); use 1x1")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    check_mesh(args.mesh)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible "
                           "(torch.cuda.is_available() is false); pass "
                           "--device cpu to run on the CPU")
    cfg = get_config(args.arch, smoke=args.smoke)
    model = init_model(cfg, torch.Generator(device).manual_seed(0),
                       device=device)
    state = init_train_state(cfg, model)
    step_fn, _ = make_train_step(cfg, q_block=min(args.seq_len, 512))

    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        state, start = restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    ds = TokenDataset(DataConfig(cfg.vocab, args.seq_len, args.batch))
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    strag = StragglerDetector()
    guard = StepGuard(reload_fn=lambda: restore(args.ckpt_dir, state)[0])

    for i in range(start, start + args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.batch_at(i).items()}
        t0 = time.time()
        state, metrics = guard.run(step_fn, state, batch)
        dt = time.time() - t0
        flagged = strag.record(i, dt)
        if i % 5 == 0 or flagged:
            print(f"step {i}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.0f}ms{' STRAGGLER' if flagged else ''}",
                  flush=True)
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, state)
    ckpt.wait()
    print("training done; retries:", guard.retries)


if __name__ == "__main__":
    main()
