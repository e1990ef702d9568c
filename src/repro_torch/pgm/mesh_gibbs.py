"""Distributed checkerboard Gibbs: inter-core register sharing (C3).

The port of the JAX package's ``repro.pgm.mesh_gibbs``.  The AIA mesh
lets a core read its N/E/S/W neighbours' shared registers in one cycle
instead of bouncing through the global buffer.  The MRF lattice is split
into tiles over a 2D ``("row", "col")`` :class:`repro_torch.launch.mesh.
DeviceMesh`, one tile a mesh position on that position's device, and
each tile receives **one-site halos** from its four neighbours before
each checkerboard half-step: ``Tensor.to(neighbour_device)`` copies of
the neighbours' edge rows and columns; tiles on the lattice's edge get
zeros there.

The "global buffer" baseline the paper compares against is kept beside
it: ``comm="allgather"`` copies every other tile to every tile each
half-step.  Per half-step a tile receives at most ``2·(ht+wt)·B·4``
bytes of halo (an interior tile; edge tiles fewer) against
``(H·W − ht·wt)·B·4`` through the all-gather.  The step counts the bytes
it copies between mesh positions (:attr:`MeshGibbsStep.comm_bytes`); on
a mesh that repeats one device ``.to`` copies nothing, and the count is
the same.

Grids whose H or W is not a tile multiple are padded; pad sites are
pinned to label 0 by their unary term *and* masked out of their real
neighbours' pairwise sums by the validity mask :func:`pad_mrf` /
:func:`shard_mrf` produce.

Bit identity with the reference: tile ``(r, c)`` draws from
``fold_in(key, r·nc + c)`` split into the two half-steps' keys, over its
own ``B·ht·wt`` lanes, exactly as the reference's ``shard_map`` body
does; ``sampler="cuda"`` hands the fused kernel ``(-e)`` (negation is
exact, so ``(-e) - max(-e) == -(e - min e)``: the plain tail's floats),
and ``sampler="torch"`` runs the plain tail.  Both give the reference's
labels and per-tile bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import DEFAULT_K
from repro_torch.core.ky import ky_sample
from repro_torch.kernels.fused_sweep import fused_gibbs_sample
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.pgm.compile import _check_sampler, _exp_on
from repro_torch.pgm.gibbs import _weights_from_energies
from repro_torch.pgm.graph import MRFGrid

COMMS = ("halo", "allgather")


class Tiles:
    """One tensor a mesh position: ``grid[r][c]`` on the device of
    position ``(r, c)``.  ``dims`` are the (row, col) dimensions the
    global tensor was cut along, or None for a tensor replicated on every
    position (then each entry is the whole tensor)."""

    def __init__(self, grid: list[list[torch.Tensor]],
                 dims: tuple[int, int] | None):
        self.grid = grid
        self.dims = dims

    @classmethod
    def split(cls, x: torch.Tensor, devices: np.ndarray,
              dims: tuple[int, int] | None) -> "Tiles":
        """Cut ``x`` into ``devices.shape`` equal tiles along ``dims``
        (or replicate it, ``dims=None``) and place each on its device."""
        nr, nc = devices.shape
        if dims is None:
            return cls([[x.to(devices[r, c]) for c in range(nc)]
                        for r in range(nr)], None)
        dr, dc = dims
        if x.shape[dr] % nr or x.shape[dc] % nc:
            raise ValueError(f"shape {tuple(x.shape)} does not tile over "
                             f"{nr} x {nc}")
        rows = torch.chunk(x, nr, dim=dr)
        return cls([[t.to(devices[r, c]) for c, t in
                     enumerate(torch.chunk(rows[r], nc, dim=dc))]
                    for r in range(nr)], dims)

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.grid), len(self.grid[0])

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: tile (0, 0)'s)."""
        device = device or self.grid[0][0].device
        if self.dims is None:
            return self.grid[0][0].to(device)
        dr, dc = self.dims
        return torch.cat([torch.cat([t.to(device) for t in row], dim=dc)
                          for row in self.grid], dim=dr)


def _tile_devices(mesh: DeviceMesh, row_axis: str, col_axis: str):
    if set(mesh.axis_names) != {row_axis, col_axis}:
        raise ValueError(f"mesh axes {mesh.axis_names} are not "
                         f"({row_axis!r}, {col_axis!r})")
    devs = mesh.devices
    return devs if mesh.axis_names[0] == row_axis else devs.T


def pad_mrf(
    mrf: MRFGrid, nr: int, nc: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Pad unary to tile multiples; returns (unary, pairwise, valid, H', W').

    Pad (dummy) sites are pinned to label 0 by a huge unary penalty on
    every other label, and ``valid`` — True exactly on the true H×W
    extent — masks them out of their neighbours' pairwise sums.  The
    pinning alone is NOT enough: pad sites sit next to real boundary
    sites, so without the mask they inject label-0 pairwise energy into
    rows h-1 / cols w-1 and bias the marginals whenever H or W is not a
    tile multiple.
    """
    h, w = mrf.shape
    hp, wp = -h % nr, -w % nc
    unary = np.pad(np.asarray(mrf.unary, np.float32),
                   ((0, hp), (0, wp), (0, 0)))
    if hp or wp:
        unary[h:, :, 1:] = 1e6
        unary[:, w:, 1:] = 1e6
    valid = np.zeros((h + hp, w + wp), bool)
    valid[:h, :w] = True
    return unary, np.asarray(mrf.pairwise, np.float32), valid, h + hp, w + wp


def _halo_exchange(labels: Tiles, r: int, c: int) -> tuple[torch.Tensor, int]:
    """Tile ``(r, c)``'s (B, ht+2, wt+2) labels framed by its N/S/W/E
    neighbours' edge rows and columns, copied to its device (zeros on the
    lattice's edge and in the corners), and the bytes copied.  Which halo
    entries count is the validity mask's business."""
    nr, nc = labels.shape
    tile = labels.grid[r][c]
    dev = tile.device
    b, ht, wt = tile.shape
    padded = torch.zeros((b, ht + 2, wt + 2), dtype=tile.dtype, device=dev)
    padded[:, 1:-1, 1:-1] = tile
    moved = 0
    if r > 0:            # north neighbour's last row
        padded[:, 0, 1:-1] = labels.grid[r - 1][c][:, -1, :].to(dev)
        moved += b * wt
    if r < nr - 1:       # south neighbour's first row
        padded[:, -1, 1:-1] = labels.grid[r + 1][c][:, 0, :].to(dev)
        moved += b * wt
    if c > 0:            # west neighbour's last column
        padded[:, 1:-1, 0] = labels.grid[r][c - 1][:, :, -1].to(dev)
        moved += b * ht
    if c < nc - 1:       # east neighbour's first column
        padded[:, 1:-1, -1] = labels.grid[r][c + 1][:, :, 0].to(dev)
        moved += b * ht
    return padded, moved * tile.element_size()


def _allgather_window(labels: Tiles, r: int, c: int) -> tuple[torch.Tensor,
                                                             int]:
    """The global-buffer baseline: every tile copied to tile ``(r, c)``'s
    device, the whole field framed by zeros, and the tile's (B, ht+2,
    wt+2) window of it; and the bytes copied (every other tile)."""
    tile = labels.grid[r][c]
    dev = tile.device
    b, ht, wt = tile.shape
    full = labels.gather(dev)
    padded = torch.zeros((b, full.shape[1] + 2, full.shape[2] + 2),
                         dtype=tile.dtype, device=dev)
    padded[:, 1:-1, 1:-1] = full
    window = padded[:, r * ht:r * ht + ht + 2, c * wt:c * wt + wt + 2]
    return window, (full.numel() - tile.numel()) * tile.element_size()


def _tile_energies(padded: torch.Tensor, valid: torch.Tensor,
                   unary_tile: torch.Tensor,
                   pairwise: torch.Tensor) -> torch.Tensor:
    """(B, ht, wt, L) candidate-label energies from halo-padded labels:
    the unary, then the north, south, west and east neighbours' pairwise
    rows, each masked by the neighbour's validity — the reference's
    association."""
    pwt = pairwise.T  # pw[l, m] -> row per neighbour label m
    ht, wt = unary_tile.shape[:2]

    def contrib(sl_r, sl_c):
        nbr = padded[:, sl_r, sl_c].to(torch.int64)
        v = valid[sl_r, sl_c]
        return pwt[nbr] * v[None, :, :, None]

    inner_r, inner_c = slice(1, ht + 1), slice(1, wt + 1)
    e = unary_tile[None]
    e = e + contrib(slice(0, ht), inner_c)        # north
    e = e + contrib(slice(2, ht + 2), inner_c)    # south
    e = e + contrib(inner_r, slice(0, wt))        # west
    e = e + contrib(inner_r, slice(2, wt + 2))    # east
    return e


class MeshGibbsStep:
    """One distributed full sweep (two checkerboard half-steps) over a
    tile mesh: ``step(key, labels, unary, pairwise, valid[, clamp]) ->
    (labels, bits)``, every operand a :class:`Tiles` from
    :func:`shard_mrf` (``valid`` the blocked halo-padded validity mask;
    ``clamp`` from :func:`shard_clamp` when built with
    ``clamped=True``).  ``bits`` is the (nr, nc) int64 grid of random bits
    spent by real (non-pad, unclamped) sites this sweep, on tile (0, 0)'s
    device; its sum is the sweep's total.

    ``comm_bytes`` counts the label bytes copied between mesh positions
    by every half-step so far, ``halfsteps`` the half-steps."""

    def __init__(self, mesh: DeviceMesh, *, row_axis: str = "row",
                 col_axis: str = "col", k: int = DEFAULT_K,
                 use_iu: bool = True, sampler: str | None = None,
                 comm: str = "halo", clamped: bool = False):
        if comm not in COMMS:
            raise ValueError(f"comm {comm!r} not in {COMMS}")
        self.devices = _tile_devices(mesh, row_axis, col_axis)
        self.nr, self.nc = self.devices.shape
        self.sampler = sampler or ("cuda" if mesh.device_type == "cuda"
                                   else "torch")
        for d in self.devices.flat:
            _check_sampler(self.sampler, d)
        self.k, self.use_iu = k, use_iu
        self.comm, self.clamped = comm, clamped
        self.comm_bytes = 0
        self.halfsteps = 0

    def _frame(self, labels: Tiles, r: int, c: int) -> torch.Tensor:
        exchange = (_halo_exchange if self.comm == "halo"
                    else _allgather_window)
        padded, moved = exchange(labels, r, c)
        self.comm_bytes += moved
        return padded

    def _sample(self, key, e: torch.Tensor):
        l = e.shape[-1]
        if self.sampler == "cuda":
            return fused_gibbs_sample(
                key, (-e).reshape((-1, l)), l, k=self.k, use_iu=self.use_iu,
                table=_exp_on(str(e.device)))
        wts = _weights_from_energies(e, k=self.k, use_iu=self.use_iu)
        return ky_sample(key, wts.reshape((-1, l)))

    def __call__(self, key, labels: Tiles, unary: Tiles, pairwise: Tiles,
                 valid: Tiles, clamp: Tiles | None = None):
        if self.clamped != (clamp is not None):
            raise ValueError("a clamped step takes a clamp operand, and "
                             "only a clamped step does")
        nr, nc = self.nr, self.nc
        keys, update = {}, {}
        for r in range(nr):
            for c in range(nc):
                keys[r, c] = rng_lib.split(rng_lib.fold_in(key, r * nc + c))
                pv = valid.grid[r][c]
                tile_valid = pv[1:-1, 1:-1]
                if clamp is not None:
                    tile_valid = tile_valid & ~clamp.grid[r][c]
                b, ht, wt = labels.grid[r][c].shape
                dev = pv.device
                gi = r * ht + torch.arange(ht, device=dev)[:, None]
                gj = c * wt + torch.arange(wt, device=dev)[None, :]
                # pad (and clamped) sites neither update nor count bits
                update[r, c] = [((gi + gj) % 2 == p) & tile_valid
                                for p in (0, 1)]
        bits = [[None] * nc for _ in range(nr)]
        for parity in (0, 1):
            # every tile's frame is cut from the labels of the previous
            # half-step, then every tile updates
            frames = [[self._frame(labels, r, c) for c in range(nc)]
                      for r in range(nr)]
            grid = [[None] * nc for _ in range(nr)]
            for r in range(nr):
                for c in range(nc):
                    tile = labels.grid[r][c]
                    e = _tile_energies(frames[r][c], valid.grid[r][c],
                                       unary.grid[r][c], pairwise.grid[r][c])
                    res = self._sample(keys[r, c][parity], e)
                    mask = update[r, c][parity][None]
                    grid[r][c] = torch.where(
                        mask, res.sample.reshape(tile.shape).to(tile.dtype),
                        tile)
                    spent = torch.where(
                        mask, res.bits_used.reshape(tile.shape), 0).sum()
                    bits[r][c] = spent if parity == 0 else bits[r][c] + spent
            labels = Tiles(grid, labels.dims)
            self.halfsteps += 1
        dev0 = self.devices[0, 0]
        out = torch.stack([torch.stack([b.to(dev0) for b in row])
                           for row in bits]).to(torch.int64)
        return labels, out


def make_mesh_gibbs_step(
    mesh: DeviceMesh,
    *,
    row_axis: str = "row",
    col_axis: str = "col",
    k: int = DEFAULT_K,
    use_iu: bool = True,
    sampler: str | None = None,
    comm: str = "halo",  # "halo" (C3) | "allgather" (global-buffer baseline)
    clamped: bool = False,
) -> MeshGibbsStep:
    """Build the distributed full-sweep function (:class:`MeshGibbsStep`).

    ``sampler`` is ``"cuda"`` (the fused kernel on every tile; the
    default on a CUDA mesh) or ``"torch"`` (the plain path; the default
    on a CPU mesh).  With ``clamped=True`` the step takes a trailing
    ``clamp`` operand (:func:`shard_clamp`): clamped sites are left out
    of the update and the bit count but stay inside the validity mask,
    so their fixed labels keep feeding their neighbours' pairwise
    energy — evidence conditioning, not lattice surgery."""
    return MeshGibbsStep(mesh, row_axis=row_axis, col_axis=col_axis, k=k,
                         use_iu=use_iu, sampler=sampler, comm=comm,
                         clamped=clamped)


def blocked_validity(valid: np.ndarray, nr: int, nc: int) -> np.ndarray:
    """Per-tile padded validity masks, blocked by tile.

    From the (H', W') extent mask, build a (nr*(ht+2), nc*(wt+2)) array
    whose (r, c) block is tile (r, c)'s halo-padded mask: the tile's own
    sites plus its one-site neighbour ring, False outside the global
    lattice and on pad sites.  Static data, computed once on the host.
    """
    hp, wp = valid.shape
    ht, wt = hp // nr, wp // nc
    g = np.zeros((hp + 2, wp + 2), bool)
    g[1:-1, 1:-1] = valid
    out = np.zeros((nr * (ht + 2), nc * (wt + 2)), bool)
    for r in range(nr):
        for c in range(nc):
            out[r * (ht + 2):(r + 1) * (ht + 2),
                c * (wt + 2):(c + 1) * (wt + 2)] = (
                g[r * ht:r * ht + ht + 2, c * wt:c * wt + wt + 2])
    return out


def shard_mrf(mesh: DeviceMesh, mrf: MRFGrid, n_chains: int, key,
              row_axis: str = "row", col_axis: str = "col"):
    """Pad the MRF and place it, its validity mask and an initial label
    field on the mesh's tiles; returns ``(labels, unary, pairwise, valid,
    (H', W'))``, the first four :class:`Tiles`.  The initial labels are
    ``randint(key, (n_chains, H', W'), 0, L)`` made globally (pad sites
    pinned to 0), then cut.  ``valid`` holds the blocked per-tile padded
    masks of :func:`blocked_validity` — pass it straight to the step."""
    devices = _tile_devices(mesh, row_axis, col_axis)
    nr, nc = devices.shape
    unary, pairwise, valid, hp, wp = pad_mrf(mrf, nr, nc)
    dev0 = devices[0, 0]
    labels0 = rng_lib.randint(key, (n_chains, hp, wp), 0, mrf.n_labels,
                              device=dev0)
    labels0 = torch.where(torch.as_tensor(valid, device=dev0)[None],
                          labels0, 0)                       # pin pad sites
    lab = Tiles.split(labels0, devices, (1, 2))
    u = Tiles.split(torch.as_tensor(unary), devices, (0, 1))
    pw = Tiles.split(torch.as_tensor(pairwise), devices, None)
    v = Tiles.split(torch.as_tensor(blocked_validity(valid, nr, nc)),
                    devices, (0, 1))
    return lab, u, pw, v, (hp, wp)


def shard_clamp(mesh: DeviceMesh, clamp: np.ndarray, values: np.ndarray,
                labels: Tiles, row_axis: str = "row",
                col_axis: str = "col") -> tuple[Tiles, Tiles]:
    """Pad and place a pixel-evidence mask for the clamped step.

    ``clamp``/``values`` are (H, W) over the *true* lattice; ``labels``
    is the padded field from :func:`shard_mrf`.  Returns ``(labels,
    clamp)``: the labels with every clamped site pinned to its observed
    value, and the (H', W') mask cut like the lattice — the trailing
    operand of ``make_mesh_gibbs_step(clamped=True)``.  Pad sites stay
    unclamped: the validity mask already freezes them."""
    devices = _tile_devices(mesh, row_axis, col_axis)
    full = labels.gather()
    _, hp, wp = full.shape
    h, w = np.asarray(clamp).shape
    pc = np.zeros((hp, wp), bool)
    pc[:h, :w] = np.asarray(clamp, bool)
    pv = np.zeros((hp, wp), np.int32)
    pv[:h, :w] = np.where(np.asarray(clamp, bool),
                          np.asarray(values, np.int32), 0)
    dev = full.device
    full = torch.where(torch.as_tensor(pc, device=dev)[None],
                       torch.as_tensor(pv, device=dev)[None], full)
    return (Tiles.split(full, devices, (1, 2)),
            Tiles.split(torch.as_tensor(pc), devices, (0, 1)))
