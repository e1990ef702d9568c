"""The mesh's "dots" remat and Adafactor's update where its blocks lie, on
("data", "model") meshes of repeated ``cpu`` devices, against the same
step on the mesh with ``remat="full"``, against one device and against
the JAX package.

Tolerances, fixed before the tests were run:

* "dots" against "full" on the same mesh: the loss and every gradient
  bit for bit (a replayed product is the value the recompute makes);
  against the reference's jitted step with ``remat="dots"``: granite's
  bounds (``tests/test_torch_sharding.py``: loss within 1e-4, parameters
  within 5e-4 after one float32 step).
* Adafactor on the mesh, on the same gradients as one device and the
  reference: the factored moments within the one-device bounds of
  ``tests/test_torch_training.py`` (the port's float32 means within
  ``PORT_MEAN_ULPS`` of float64 means, the port and the reference within
  ``PAIR_MEAN_ULPS`` of each other) plus one rounding for each split of
  the summed dim (a dim cut into ``s`` blocks adds ``s - 1`` partial
  sums); unfactored moments within 1 ulp of one device's; parameters
  within ``chip_smoke.py``'s ``LM_MESH_BF16`` bound of one device's and
  of the reference's (2 x 2.1 x 3e-4, plus one bf16 step of the
  parameter).
* The bytes the update copies between mesh positions equal the
  statistics reckoned here from the layouts, element by element."""
import _threads  # noqa: F401  (torch threads under xdist)
import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import train_step as j_ts  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.mesh import make_lm_mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.training import DataConfig, TokenDataset  # noqa: E402
from repro_torch.training import optimizer as t_opt  # noqa: E402
from repro_torch.training import train_step as t_ts  # noqa: E402
from repro_torch.training.optimizer import map_leaf  # noqa: E402

CPU = torch.device("cpu")
PORT_MEAN_ULPS, PAIR_MEAN_ULPS = 4.0, 8.0       # test_torch_training.py
LM_MESH_BF16_PARAM = 2 * 2.1 * 3e-4             # chip_smoke.py LM_MESH_BF16


def _batch(cfg, b=8, s=16, seed=0):
    ds = TokenDataset(DataConfig(cfg.vocab, s, b))
    return {k: torch.from_numpy(v) for k, v in ds.batch_at(seed).items()}


def _mesh(d, m):
    return make_lm_mesh(d, m, devices=[CPU] * (d * m))


# --------------------------------------------------------------------------
# the "dots" remat on a mesh
# --------------------------------------------------------------------------

def _mesh_loss_grads(cfg, model, mesh, batch):
    m = copy.deepcopy(model)
    m.cfg = cfg
    tt.place_model(mesh, m)
    (run, shards), = t_ts.split_batch(mesh, batch, 1)
    loss = tt.mesh_loss(m, run, shards, 8)
    loss.backward()
    return loss.detach(), {
        k: partition.gather(map_leaf(p, lambda t: t.grad), CPU)
        for k, p in tt.param_leaves(m).items()}


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "hymba-1.5b"])
def test_dots_on_2x2_is_bitwise_with_full_and_replays_every_product(arch):
    """phi4-mini and hymba smoke in float32 on 2 x 2: the loss and every
    gradient of "dots" equal "full"'s bit for bit, and every matrix
    product the forward recorded is returned in the recompute instead of
    being run again (records and replays counted)."""
    cfg = t_configs.get_config(arch, smoke=True).replace(dtype="float32")
    model = tt.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    batch = _batch(cfg)
    lf, gf = _mesh_loss_grads(cfg, model, _mesh(2, 2), batch)
    tt.DOTS_COUNTS.update(saved=0, replayed=0)
    ld, gd = _mesh_loss_grads(cfg.replace(remat="dots"), model, _mesh(2, 2),
                              batch)
    assert tt.DOTS_COUNTS["saved"] == tt.DOTS_COUNTS["replayed"] > 0
    assert torch.equal(ld, lf)
    assert sorted(gd) == sorted(gf)
    for k in gf:
        assert torch.equal(gd[k], gf[k]), k


def test_dots_replay_refuses_a_record_that_does_not_match():
    """The recompute takes each record in order only where it is the
    same op with the output's shape, dtype and device; else it raises."""
    a, b = torch.ones(2, 3), torch.ones(3, 4)
    with tt._SaveDots() as save:
        want = torch.mm(a, b)
    with tt._ReplayDots(list(save.saved)):
        assert torch.mm(a, b) is save.saved[0][1]
    for op, out in ((torch.ops.aten.bmm.default, want),
                    (torch.ops.aten.mm.default, want[:, :3]),
                    (torch.ops.aten.mm.default, want.double())):
        with pytest.raises(RuntimeError, match="dots remat"):
            with tt._ReplayDots([(op, out)]):
                torch.mm(a, b)
    with pytest.raises(RuntimeError, match="no record"):
        with tt._ReplayDots([]):
            torch.mm(a, b)


def test_dots_2x2_step_matches_the_reference_dots_step():
    """phi4-mini smoke, float32, ``remat="dots"``: one step on 2 x 2
    against the reference's jitted step from the same state."""
    jcfg = j_configs.get_config("phi4-mini-3.8b", smoke=True).replace(
        dtype="float32", remat="dots")
    tcfg = t_configs.get_config("phi4-mini-3.8b", smoke=True).replace(
        dtype="float32", remat="dots")
    jstate = j_ts.init_train_state(jcfg, jt.init_model(
        jax.random.PRNGKey(0), jcfg))
    mesh = _mesh(2, 2)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, device=CPU, mesh=mesh)
    batch = _batch(tcfg)
    jstate, jm = jax.jit(j_ts.make_train_step(jcfg, q_block=8)[0])(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    tt.DOTS_COUNTS.update(saved=0, replayed=0)
    tstate, tm = t_ts.make_train_step(tcfg, q_block=8, mesh=mesh)[0](
        tstate, batch)
    assert tt.DOTS_COUNTS["saved"] == tt.DOTS_COUNTS["replayed"] > 0
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-4
    got = convert.train_state_to_numpy(tstate)
    for k, w in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        g = got.params
        for p in k:
            g = g[p.key]
        assert np.abs(g - np.asarray(w)).max() < 5e-4, k


# --------------------------------------------------------------------------
# Adafactor where its blocks lie
# --------------------------------------------------------------------------

def _ref_grads(jparams, seed):
    """Normal draws times 1e-3, every fifth element zero, in each leaf's
    dtype (as ``test_torch_training.py``'s)."""
    r = np.random.default_rng(seed)

    def one(p):
        g = (r.standard_normal(p.shape) * 1e-3).astype(np.float32)
        g.reshape(-1)[::5] = 0.0
        return jnp.asarray(g).astype(p.dtype)

    return jax.tree.map(one, jparams)


def _port_grads(jgrads, params):
    """The reference's gradients as the port's leaves, placed as the
    parameters are (a gradient's blocks are its parameter's)."""
    flat = {"/".join(str(k.key) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    out = {}
    for key, p in params.items():
        g = convert._tensor(flat[key])
        if isinstance(p, list):
            out[key] = [_like(x, t) for x, t in zip(p, g.unbind(0))]
        else:
            out[key] = _like(p, g)
    return out


def _like(p, g):
    """``g`` in ``p``'s dtype, placed as ``p`` is."""
    if isinstance(p, partition.Sharded):
        return partition.Sharded.place(p.mesh, g.to(p.dtype), p.spec)
    return g.to(p.dtype)


def _positions(leaf, shape):
    """An int array over ``shape``: the flat mesh position of the block
    that holds each element (a list of layer tensors stacked)."""
    out = np.zeros(shape, dtype=np.int64)
    layers = leaf if isinstance(leaf, list) else [leaf]
    for li, sh in enumerate(layers):
        for c in sh.coords():
            sl = tuple(slice(a, b) for a, b in sh.box(c))
            if isinstance(leaf, list):
                sl = (li,) + sl
            out[sl] = np.ravel_multi_index(sh.position(c),
                                           sh.mesh.devices.shape)
    return out


def _blocks_along(pos, axis, n):
    """``pos`` sampled at the first element of each of the ``n`` blocks
    along ``axis``."""
    step = pos.shape[axis] // n
    return np.take(pos, np.arange(0, pos.shape[axis], step), axis=axis)


def _splits(leaf):
    return ((len(leaf),) + leaf[0].splits if isinstance(leaf, list)
            else leaf.splits)


def _reckon(params, state) -> int:
    """Bytes the update must copy between mesh positions, element by
    element: each gradient block's partial row (column) sums to the
    ``vr`` (``vc``) blocks that hold those rows (columns), and the
    preconditioner's slices back; each ``vr`` block's partial row sums
    of ``vr2`` to every ``vr`` block that shares its rows; an unfactored
    leaf's moments to the gradient's blocks and back; a sum of squares
    a gradient block to the first position and the clip's root back to
    each position; the clip scale and beta (8 bytes) once to every
    position that uses them."""
    total, needed = 0, set()
    for key, p in params.items():
        shp = t_opt.leaf_shape(p)
        pg = _positions(p, shp)
        pr = _positions(state.vr[key], t_opt._vr_shape(p))
        pc = _positions(state.vc[key], t_opt._vc_shape(p))
        here = set(np.unique(pg)) | set(np.unique(pr)) | set(np.unique(pc))
        if len(here) == 1:
            continue
        sp = _splits(p)
        if len(shp) >= 2:
            needed |= here
            rows = _blocks_along(pg, -1, sp[-1])          # S[:-1] x col blocks
            total += 2 * 4 * int((rows != pr[..., None]).sum())
            cols = _blocks_along(pg, -2, sp[-2])          # S[:-2] x rb x S[-1]
            total += 2 * 4 * int((cols != pc[..., None, :]).sum())
            vsp = _splits(state.vr[key])[-1]
            lead = _blocks_along(pr, -1, vsp).reshape(-1, vsp)
            for row in lead:
                total += 4 * int((row[:, None] != row[None, :]).sum())
        else:
            needed |= set(np.unique(pg))
            total += 2 * 4 * int((pg != pr).sum())
        first = pg                         # one element a gradient block
        for ax, n in enumerate(sp):
            first = _blocks_along(first, ax, n)
        total += 4 * int((first != 0).sum())               # sums of squares
        total += 4 * len(set(np.unique(pg)) - {0})         # the root back
    return total + 8 * len(needed - {0})


def _ulps(got, want, bf16=False):
    sp = np.spacing(np.abs(want).astype(np.float32)) * (65536 if bf16 else 1)
    return np.abs(np.asarray(got, np.float64) - want) / sp


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_adafactor_updates_where_its_blocks_lie(shape, monkeypatch):
    """grok-1 smoke (bf16 parameters, Adafactor): on 2 x 2 its experts
    lie over "model" and some moments over both "data" (ZeRO) and
    "model"; on 1 x 4 its expert ffn over "model".  One update on the
    same gradients as one device and the reference, at the stated
    tolerances; only statistics and scalars cross between positions (no
    copy larger than the largest ``vr``/``vc`` block), their bytes
    equal to the reckoning."""
    arch = "grok-1-314b"
    jcfg = j_configs.get_config(arch, smoke=True)
    tcfg = t_configs.get_config(arch, smoke=True)
    jstate = j_ts.init_train_state(jcfg, jt.init_model(
        jax.random.PRNGKey(0), jcfg))
    npstate = jax.tree.map(np.asarray, jstate)
    mesh = _mesh(*shape)
    one = convert.train_state_from_numpy(npstate, tcfg, device=CPU)
    sh = convert.train_state_from_numpy(npstate, tcfg, device=CPU, mesh=mesh)
    specs = [x.spec for f in (sh.opt.vr, sh.opt.vc) for x in f.values()]
    if shape == (2, 2):
        assert any("data" in s and "model" in s for s in specs)
    jg = _ref_grads(jstate.params, 1)
    jp, jopt, jn = jax.jit(j_opt.make_optimizer(jcfg).update)(
        jg, jstate.opt, jstate.params)
    opt = t_opt.make_optimizer(tcfg)
    p1, p2 = tt.param_leaves(one.model), tt.param_leaves(sh.model)
    _, o1, n1 = opt.update(_port_grads(jg, p1), one.opt, p1)

    sizes = []
    add = partition._add

    def spy(crossed, moved, kind, seg=None):
        sizes.append(crossed)
        add(crossed, moved, kind, seg)

    monkeypatch.setattr(partition, "_add", spy)
    partition.reset_traffic()
    with partition.segment("optimizer"):
        _, o2, n2 = opt.update(_port_grads(jg, p2), sh.opt, p2)
    monkeypatch.undo()
    assert abs(float(n2) - float(n1)) <= 1e-5 * float(n1)

    # bytes: the reckoned statistics, in no copy larger than a vr/vc block
    counted = sum(b for (seg, _), (_, b) in partition.KINDS.items()
                  if seg == "optimizer")
    assert counted == partition.TRAFFIC["crossed_bytes"] == _reckon(p2, sh.opt)
    largest = max(t.numel() * 4 for f in (sh.opt.vr, sh.opt.vc)
                  for x in f.values() for t in x.shards.values())
    assert 0 < max(sizes) <= largest

    # moments
    step = int(jstate.opt.step) + 1
    beta = 1.0 - float(np.float32(step) ** np.float32(-0.8))
    scale = np.float32(min(1.0, 1.0 / max(float(jn), 1e-12)))
    want_p = {jax.tree_util.keystr(p): np.asarray(x, np.float32)
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for field in ("vr", "vc"):
        ref = {"/".join(str(k.key) for k in p): np.asarray(x)
               for p, x in jax.tree_util.tree_flatten_with_path(
                   getattr(jopt, field))[0]}
        for key, p in p2.items():
            got = partition.gather(getattr(o2, field)[key], CPU).numpy()
            mine = getattr(o1, field)[key].numpy()
            shp = t_opt.leaf_shape(p)
            if len(shp) < 2:
                if field == "vr":
                    assert _ulps(got, mine).max(initial=0.0) <= 1.0, key
                continue
            # the moments with the means in float64 (test_torch_training.py's
            # _factored_moments64), then the bounds plus the split's sums
            axis = -1 if field == "vr" else -2
            s = _splits(p)[axis]
            g = np.asarray(_leaf(jg, key).astype(jnp.float32)) * scale
            g2 = (g * g + np.float32(1e-30)).astype(np.float64)
            prev = np.asarray(_leaf(getattr(jstate.opt, field), key),
                              np.float64)
            exact = beta * prev + (1 - beta) * g2.mean(axis)
            assert _ulps(got, exact).max() <= PORT_MEAN_ULPS + s - 1, key
            assert _ulps(got, ref[key]).max() <= PAIR_MEAN_ULPS + s - 1, key

    # parameters: within LM_MESH_BF16's bound of one device's and the
    # reference's
    a = {k: partition.gather(v, CPU).detach().float()
         for k, v in p1.items()}
    b = {k: partition.gather(v, CPU).detach().float()
         for k, v in p2.items()}
    for key in a:
        for want in (a[key], torch.from_numpy(want_p[_refkey(key)])):
            assert bool(((b[key] - want).abs() <= LM_MESH_BF16_PARAM
                         + 2.0 ** -7 * want.abs()).all()), key


def _leaf(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def _refkey(key):
    return "".join(f"['{p}']" for p in key.split("/"))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_adafactor_mesh_train_step_matches_one_device(shape):
    """grok-1 smoke's whole train step (microbatch 2, bf16 parameters and
    accumulation) on the mesh against one device from the same weights:
    the loss within 1e-4, the parameters within ``LM_MESH_BF16``'s
    bound."""
    cfg = t_configs.get_config("grok-1-314b", smoke=True).replace(
        microbatch=2)
    model = tt.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    one = t_ts.init_train_state(cfg, copy.deepcopy(model))
    mesh = _mesh(*shape)
    sh = t_ts.place_train_state(mesh, t_ts.init_train_state(cfg, model))
    batch = _batch(cfg)
    one, m1 = t_ts.make_train_step(cfg, q_block=8)[0](one, batch)
    sh, m2 = t_ts.make_train_step(cfg, q_block=8, mesh=mesh)[0](sh, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for k, v in tt.param_leaves(one.model).items():
        want = partition.gather(v, CPU).detach().float()
        got = partition.gather(tt.param_leaves(sh.model)[k],
                               CPU).detach().float()
        assert bool(((got - want).abs() <= LM_MESH_BF16_PARAM
                     + 2.0 ** -7 * want.abs()).all()), k
