"""An MRF grid task made on the device from the seed: the inputs both the
program and the reference get.

The paper's images are not in the repository, so each configuration's
``scene`` is synthesized at the published size: ``blobs`` is the
binary-segmentation scene (two elliptic blobs, the foreground of the
Penguin image), ``waves`` the stereo scene (a piecewise-smooth disparity
map at the Art image's size).  Observations are the truth plus Gaussian
noise of the configuration's ``noise``; the unary energy of label ``l``
is ``(obs - l)**2 / (2 noise**2)``.  Initial labels are uniform.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Task(NamedTuple):
    unary: torch.Tensor      # (H, W, L) float32
    pairwise: torch.Tensor   # (L, L) float32
    labels0: torch.Tensor    # (B, H, W) int32


def _truth(scene: str, h: int, w: int, n_labels: int, device):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64,
                                         device=device),
                            torch.arange(w, dtype=torch.float64,
                                         device=device), indexing="ij")
    if scene == "blobs":
        cy, cx = h * 0.55, w * 0.5
        blob = (((yy - cy) / (0.33 * h)) ** 2
                + ((xx - cx) / (0.28 * w)) ** 2) < 1.0
        blob |= (((yy - h * 0.25) / (0.12 * h)) ** 2
                 + ((xx - cx) / (0.10 * w)) ** 2) < 1.0
        return blob.to(torch.float64)
    if scene == "waves":
        t = (n_labels - 1) * (0.5 + 0.5 * torch.sin(3 * math.pi * xx / w)
                              * torch.cos(2 * math.pi * yy / h))
        return torch.clamp(torch.round(t), 0, n_labels - 1)
    raise ValueError(f"unknown scene {scene!r}")


def pairwise_table(cfg: dict, device) -> torch.Tensor:
    L = cfg["n_labels"]
    d = (torch.arange(L, device=device)[:, None]
         - torch.arange(L, device=device)[None, :]).abs()
    if cfg["pairwise"] == "potts":
        return (cfg["beta"] * (d != 0)).to(torch.float32)
    if cfg["pairwise"] == "truncated_linear":
        return (cfg["beta"] * torch.clamp_max(d, cfg["tau"])).to(
            torch.float32)
    raise ValueError(f"unknown pairwise {cfg['pairwise']!r}")


def make(cfg: dict, seed: int, device) -> Task:
    h, w, L, b = cfg["height"], cfg["width"], cfg["n_labels"], cfg["n_chains"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    truth = _truth(cfg["scene"], h, w, L, device)
    noise = float(cfg["noise"])
    obs = truth + noise * torch.randn((h, w), generator=gen,
                                      dtype=torch.float64, device=device)
    levels = torch.arange(L, dtype=torch.float64, device=device)
    unary = ((obs[..., None] - levels) ** 2 / (2 * noise ** 2)).to(
        torch.float32)
    labels0 = torch.randint(0, L, (b, h, w), generator=gen,
                            dtype=torch.int32, device=device)
    return Task(unary.contiguous(), pairwise_table(cfg, device), labels0)
