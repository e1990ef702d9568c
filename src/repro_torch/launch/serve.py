"""Serving launcher: batched autoregressive generation with the KY
sampler, and the posterior service's entry point on the port.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --batch 4 --prompt-len 16 --max-new 32 --sampler ky

runs ``--arch``'s model at its published width with random weights (a
``torch.Generator`` seeded 0), a prompt from ``rng.randint(PRNGKey(1),
...)`` and generation under ``PRNGKey(2)``, on the card unless
``--device cpu`` (``--smoke`` for the reduced config); it reports tok/s,
random bits per token and sample tokens.

``--stream`` replays traffic open-loop through the admission queue,
``--serve [HOST:]PORT`` runs the HTTP/WebSocket front end over a worker
pool, and ``--connect [HOST:]PORT`` drives one as a client; every other
argument is forwarded to :mod:`repro_torch.serve.cli`, which owns the
flags:

  python -m repro_torch.launch.serve --stream --network hailfinder_scale \
      --patterns 4 --slices 4 --trace-out trace.json
  python -m repro_torch.launch.serve --serve :8080 --workers 2 \
      --scheduler deadline --quota-qps 50
  python -m repro_torch.launch.serve --connect :8080 --stream \
      --network asia --queries 32
  python -m repro_torch.launch.serve --serve :8080 --mesh-shape 4

(run with ``PYTHONPATH=src``; engines run on the card unless
``--device cpu``).  The mesh flags ride along: ``--mesh-shape N|RxC``
shards every engine's lanes over a serve mesh, over every visible card
or over ``--force-host-devices N`` copies of ``--device``.
"""
from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a == "--stream" or a.split("=", 1)[0] in ("--serve", "--connect")
           for a in argv):
        from repro_torch.serve.cli import main as serve_main
        serve_main(argv)
        return

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.models.sampling import generate
    from repro_torch.models.transformer import init_model
    from repro_torch.serve.telemetry import monotonic

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--sampler", default="ky",
                    choices=("ky", "categorical", "greedy"))
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible "
                           "(torch.cuda.is_available() is false); pass "
                           "--device cpu to run on the CPU")
    cfg = get_config(args.arch, smoke=args.smoke)
    model = init_model(cfg, torch.Generator(device).manual_seed(0),
                       device=device)
    prompt = rng.randint(rng.PRNGKey(1), (args.batch, args.prompt_len), 0,
                         cfg.vocab, device=device)
    extras = {}
    if cfg.family in ("encdec", "audio"):
        extras["src_embeds"] = torch.zeros(
            (args.batch, cfg.enc_seq_len, cfg.d_model), device=device)
    if cfg.family == "vlm":
        extras["frontend"] = torch.zeros(
            (args.batch, cfg.frontend_tokens, cfg.d_model), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = monotonic()
    tokens, bits = generate(
        model, prompt, rng.PRNGKey(2), max_new=args.max_new,
        sampler=args.sampler, temperature=args.temperature,
        q_block=min(args.prompt_len, 512), **extras)
    sync()
    dt = monotonic() - t0
    n = args.batch * args.max_new
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"sampler={args.sampler}: {n} tokens in {dt:.2f}s "
          f"({n/dt:.1f} tok/s incl. warm-up, {where})")
    if args.sampler == "ky":
        print(f"random bits consumed: {bits} "
              f"({bits/n:.2f} bits/token — softmax-free KY decode)")
    print("sample tokens[0]:", np.asarray(tokens[0].cpu())[:16].tolist())


if __name__ == "__main__":
    main()
