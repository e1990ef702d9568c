"""End-to-end training driver of the port.

Config -> model and optimizer state on the device -> data pipeline ->
guarded train loop with straggler detection, async checkpointing and
crash recovery, as the reference's ``repro.launch.train``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-32b \
      --smoke --steps 20 --device cpu

runs on the card unless ``--device`` names another device (``--smoke``
for the reduced config).  Weights come from a ``torch.Generator`` seeded
0 on the device; batches are ``TokenDataset``'s.

``--mesh DxM`` trains on a ("data", "model") mesh: parameters placed by
``param_specs``, the optimizer state as the reference's builders place
it, the step split over the batch shards and (for the dense, vlm and
encoder-decoder families) tensor parallel over "model".  The mesh takes
every visible card, and too few raise; ``--devices N`` builds it over N
copies of ``--device`` instead (N ``cpu`` devices are the counterpart of
the reference's fake host devices; on one card, the card repeated):

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
      --smoke --mesh 2x2 --devices 4 --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_lm_mesh, parse_mesh_shape
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
from repro_torch.training.train_step import (
    init_train_state, make_train_step, place_train_state)


def make_mesh_arg(spec: str, device: torch.device, devices: int):
    """The ("data", "model") mesh of ``--mesh DxM``: ``None`` for a 1x1
    mesh without ``--devices`` (one device, nothing placed), else over
    ``devices`` copies of ``device`` or, without them, every visible
    card."""
    shape = parse_mesh_shape(spec)
    if len(shape) != 2:
        raise ValueError(f"--mesh {spec}: expected DxM")
    if shape == (1, 1) and not devices:
        return None
    if devices:
        return make_lm_mesh(*shape, devices=[device] * devices)
    if device.type != "cuda":
        raise SystemExit(f"--mesh {spec} on {device} needs --devices N (a "
                         "mesh of N copies of the device)")
    return make_lm_mesh(*shape)


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
    ap.add_argument("--devices", type=int, default=0,
                    help="build --mesh over this many copies of --device "
                         "(default: every visible card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible "
                           "(torch.cuda.is_available() is false); pass "
                           "--device cpu to run on the CPU")
    mesh = make_mesh_arg(args.mesh, device, args.devices)
    cfg = get_config(args.arch, smoke=args.smoke)
    if mesh is not None:
        device = mesh.devices.flat[0]
    model = init_model(cfg, torch.Generator(device).manual_seed(0),
                       device=device)
    state = init_train_state(cfg, model)
    if mesh is not None:
        state = place_train_state(mesh, state)
        print(f"mesh {mesh.shape} over {mesh.size} devices "
              f"({', '.join(sorted({str(d) for d in mesh.devices.flat}))})")
    step_fn, _ = make_train_step(cfg, q_block=min(args.seq_len, 512),
                                 mesh=mesh)

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
