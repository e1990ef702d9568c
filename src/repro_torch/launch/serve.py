"""Serving launcher — the posterior service's entry point on the port.

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
or over ``--force-host-devices N`` copies of ``--device``.  The
generation half of the reference's launcher (``--arch``: batched
autoregressive decoding) is not ported.
"""
from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a == "--stream" or a.split("=", 1)[0] in ("--serve", "--connect")
           for a in argv):
        from repro_torch.serve.cli import main as serve_main
        serve_main(argv)
        return
    raise NotImplementedError(
        "batched autoregressive generation (--arch) is not ported to "
        "repro_torch (ROADMAP Queue 1 item 6, the LM side); use --stream, "
        "--serve or --connect for the posterior service")


if __name__ == "__main__":
    main()
