"""The port's LM sharding against the JAX package on the CPU: the spec
rules (parameters, optimizer state, caches, batches, ZeRO, inputs) entry
for entry on abstract meshes, the production meshes, placement, and the
sharded train, prefill and decode steps on meshes of repeated ``cpu``
devices against one device and against the reference's step.

Weights come from a seeded ``torch.Generator`` or the reference's
``init_model`` carried over by ``convert``; batches from
``TokenDataset``/``make_batch`` (numpy, seeded).  Tolerances are the
reference's ``tests/test_distributed.py`` ones (loss within 1e-4,
parameters within 5e-4 after one float32 step) unless stated."""
import _threads  # noqa: F401  (torch threads under xdist)
import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import builders as j_builders  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.sharding import specs as j_specs  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import train_step as j_ts  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.launch import builders as t_builders  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.sharding import ctx as t_ctx  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.sharding import specs as t_specs  # noqa: E402
from repro_torch.training import DataConfig, TokenDataset  # noqa: E402
from repro_torch.training import elastic, restore, save  # noqa: E402
from repro_torch.training import train_step as t_ts  # noqa: E402
from repro_torch.training.data import make_batch  # noqa: E402

CPU = torch.device("cpu")
META = torch.device("meta")
MESHES = [(16, 16), (2, 16, 16), (4, 2), (2, 2), (4, 1), (1, 1)]
ARCHS = t_configs.ARCH_IDS
# the seven families (seamless is "audio"; "encdec" is it under the text
# family's name), and grok-1's MoE with bf16 parameters and Adafactor
FAMILIES = {"dense": ("phi4-mini-3.8b", {}), "vlm": ("pixtral-12b", {}),
            "moe": ("llama4-scout-17b-a16e", {}), "ssm": ("mamba2-130m", {}),
            "hybrid": ("hymba-1.5b", {}),
            "encdec": ("seamless-m4t-medium", {"family": "encdec"}),
            "audio": ("seamless-m4t-medium", {}),
            "moe_adafactor": ("grok-1-314b", {})}


def _family_cfg(family):
    arch, kw = FAMILIES[family]
    return t_configs.get_config(arch, smoke=True).replace(**kw)


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(shape):
    """(reference AbstractMesh, port DeviceMesh of meta devices)."""
    n = int(np.prod(shape))
    t = t_mesh.DeviceMesh(np.array([META] * n, dtype=object).reshape(shape),
                          _axes(shape))
    return AbstractMesh(shape, _axes(shape)), t


def _keyed(tree) -> dict:
    """Reference tree -> {"a/b/c": leaf} (dict keys and NamedTuple
    fields)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)] = leaf
    return out


def _ref_params_sds(arch):
    cfg = j_configs.get_config(arch)
    return cfg, j_builders._params_sds(cfg)


# --------------------------------------------------------------------------
# spec rules, entry for entry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch):
    """``param_specs`` and the optimizer-state specs (``_opt_specs``) of
    every full-width leaf on the production and small meshes."""
    jcfg, jp = _ref_params_sds(arch)
    tcfg = t_configs.get_config(arch)
    leaves = tt.param_leaves(t_builders._params_sds(tcfg))
    jopt = jax.eval_shape(j_opt.make_optimizer(jcfg).init, jp)
    topt = t_builders.make_optimizer(tcfg).init(leaves)
    for shape in MESHES:
        jm, tm = _meshes(shape)
        jspec = j_specs.param_specs(jcfg, jp, jm)
        want = {k: tuple(v) for k, v in _keyed(jspec).items()}
        got = t_specs.param_specs(tcfg, leaves, tm)
        assert got == want, shape
        jo = _keyed(j_builders._opt_specs(jopt, jspec, jm))
        to = t_builders._opt_specs(topt, got, tm)
        got_o = {f"{f}/{k}": s for f in to._fields if f != "step"
                 for k, s in getattr(to, f).items()}
        want_o = {k: tuple(v) for k, v in jo.items()
                  if not k.startswith("step")}
        assert got_o == want_o, shape
        for k, leaf in leaves.items():       # zero_extend, leaf by leaf
            shp = t_specs._shape(leaf)
            assert t_specs.zero_extend(got[k], shp, tm) == tuple(
                j_specs.zero_extend(jspec_leaf(jspec, k), shp, jm)), (k, shape)


def jspec_leaf(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_and_input_specs_equal_the_reference(arch):
    """``input_specs`` over the arch's four shape cells (shapes and
    dtypes), ``batch_specs`` and ``batch_spec_axis`` on them, and
    ``cache_specs`` on ``init_cache`` stand-ins."""
    jcfg = j_configs.get_config(arch)
    tcfg = t_configs.get_config(arch)
    for shape in t_configs.SHAPES:
        jin = j_configs.input_specs(jcfg, shape)
        tin = t_configs.input_specs(tcfg, shape)
        assert set(jin) == set(tin)
        for k in jin:
            assert tuple(tin[k].shape) == jin[k].shape, (k, shape.name)
            assert tin[k].device == META
            assert str(tin[k].dtype).removeprefix("torch.") == \
                jin[k].dtype.name
        b, t = shape.global_batch, min(shape.seq_len, 64)
        jc = jax.eval_shape(lambda: jt.init_cache(jcfg, b, t))
        tc = tt.init_cache(tcfg, b, t, device=META)
        for mshape in MESHES:
            jm, tm = _meshes(mshape)
            assert t_specs.batch_specs(tcfg, tm, tin) == {
                k: tuple(v) for k, v in
                j_specs.batch_specs(jcfg, jm, jin).items()}
            for n in (1, 2, 3, 8, 12, 32, 256, 512):
                assert t_specs.batch_spec_axis(tm, n) == \
                    j_specs.batch_spec_axis(jm, n), (mshape, n)
            want = {k: tuple(v) for k, v in
                    j_specs.cache_specs(jcfg, jm, jc, b).items()}
            assert t_specs.cache_specs(tcfg, tm, tc, b) == want, mshape


def test_make_production_mesh_builds_over_meta_and_refuses_too_few():
    m = t_mesh.make_production_mesh(devices=[META] * 256)
    assert m.shape == {"data": 16, "model": 16}
    mp = t_mesh.make_production_mesh(multi_pod=True, devices=[META] * 512)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="needs 256 devices, have 3"):
        t_mesh.make_production_mesh(devices=[CPU] * 3)
    n = torch.cuda.device_count()
    if n < 256:
        with pytest.raises(RuntimeError, match=f"have {n}"):
            t_mesh.make_production_mesh()


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [("data", "model"), ("model", None),
                                  (None, ("data", "model")), (), ("data",)])
def test_place_and_gather_round_trip(spec):
    mesh = t_mesh.make_lm_mesh(2, 2, devices=[CPU] * 4)
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    sh = partition.Sharded.place(mesh, x, spec)
    n = int(np.prod(sh.splits))
    assert len(sh.shards) == n
    assert sum(t.numel() for t in sh.shards.values()) == x.numel()
    torch.testing.assert_close(sh.gather(CPU), x, rtol=0, atol=0)
    for box, t in sh.boxes():           # every block is its own copy
        assert t.data_ptr() != x.data_ptr()
        torch.testing.assert_close(
            t, x[tuple(slice(a, b) for a, b in box)], rtol=0, atol=0)


def test_gather_backward_sums_consumers_in_order_and_counts_traffic():
    mesh = t_mesh.make_lm_mesh(2, 2, devices=[CPU] * 4)
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    sh = partition.Sharded.place(mesh, x, ("data", "model"),
                                 requires_grad=True)
    partition.reset_traffic()
    run = partition.MeshRun(mesh, "data")
    with run.scope():
        outs = []
        for i in range(run.n):
            for j in range(run.tp):
                outs.append(run.weight(sh, "x", i, j, False))
    assert partition.TRAFFIC["crossed_bytes"] > 0
    assert partition.TRAFFIC["moved_bytes"] == 0      # one torch device
    sum(o.sum() * (k + 1) for k, o in enumerate(outs)).backward()
    # piece j of data shard i is x[:, j block] (gathered over "data");
    # its gradient is (index + 1) everywhere
    want = torch.zeros_like(x)
    for k in range(4):
        j = k % 2
        want[:, 3 * j: 3 * j + 3] += k + 1
    got = partition.Sharded(mesh, sh.spec, sh.shape,
                            {c: t.grad for c, t in sh.shards.items()})
    torch.testing.assert_close(got.gather(CPU), want, rtol=0, atol=0)


def test_observe_copies_sees_each_copy_between_positions():
    """``partition.observe_copies`` tells its function of each copy
    between two mesh positions made in its block, and of nothing else:
    the copies it sees are those :data:`partition.TRAFFIC` counts."""
    x = torch.arange(24.0).reshape(4, 6)
    seen = []

    def observe(t, src, dst, kind):
        seen.append((tuple(t.shape), t.numel() * t.element_size(), src,
                     dst, kind))

    partition.reset_traffic()
    with partition.observe_copies(observe):
        partition.move(x, CPU, (0, 0), (0, 1))
        partition.move(x[:2], CPU, (1, 0), (0, 0), "input")
        partition.move(x, CPU, (1, 1), (1, 1))            # not a copy
    partition.move(x, CPU, (0, 0), (1, 0))                # not observed
    assert seen == [((4, 6), 96, (0, 0), (0, 1), "reshard"),
                    ((2, 6), 48, (1, 0), (0, 0), "input")]
    assert partition.TRAFFIC["crossed_copies"] == 3
    assert partition.TRAFFIC["crossed_bytes"] == 96 + 48 + 96
    assert not partition._OBSERVERS


# --------------------------------------------------------------------------
# the sharded train step
# --------------------------------------------------------------------------

def _batch(cfg, seed=0, b=8, s=16):
    ds = TokenDataset(DataConfig(cfg.vocab, s, b))
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(seed).items()}
    g = torch.Generator().manual_seed(seed + 3)
    if cfg.family == "vlm":
        batch["frontend"] = torch.randn(b, cfg.frontend_tokens, cfg.d_model,
                                        generator=g)
    if cfg.family in ("encdec", "audio"):
        batch["src_embeds"] = torch.randn(b, cfg.enc_seq_len, cfg.d_model,
                                          generator=g)
    return batch


def _states(cfg, d, m, seed=0):
    model = tt.init_model(cfg, torch.Generator().manual_seed(seed),
                          device=CPU)
    one = t_ts.init_train_state(cfg, copy.deepcopy(model))
    mesh = t_mesh.make_lm_mesh(d, m, devices=[CPU] * (d * m))
    sharded = t_ts.place_train_state(
        mesh, t_ts.init_train_state(cfg, model))
    return one, sharded, mesh


def _params(state) -> dict:
    return {k: partition.gather(v, CPU).detach().float()
            for k, v in tt.param_leaves(state.model).items()}


def _step_both(cfg, d, m, batch, seed=0):
    one, sharded, mesh = _states(cfg, d, m, seed)
    one, m1 = t_ts.make_train_step(cfg, q_block=8)[0](one, batch)
    sharded, m2 = t_ts.make_train_step(cfg, q_block=8, mesh=mesh)[0](
        sharded, batch)
    return (one, m1), (sharded, m2)


def _param_tol(cfg, want):
    """5e-4; a bfloat16 parameter also one bf16 step of its size."""
    return 5e-4 + (2.0 ** -7 * want.abs() if cfg.param_dtype == "bfloat16"
                   else 0)


def test_granite_4x2_step_equals_one_device_and_the_reference():
    """The reference's own case (tests/test_distributed.py): granite-20b
    smoke in float32 on a 4 x 2 mesh, one step, against the port's one
    device and the reference's jitted step from the same state."""
    jcfg = j_configs.get_config("granite-20b", smoke=True).replace(
        dtype="float32")
    tcfg = t_configs.get_config("granite-20b", smoke=True).replace(
        dtype="float32")
    jstate = j_ts.init_train_state(jcfg, jt.init_model(
        jax.random.PRNGKey(0), jcfg))
    mesh = t_mesh.make_lm_mesh(4, 2, devices=[CPU] * 8)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, device=CPU, mesh=mesh)
    assert tstate.model.mesh is mesh
    batch = _batch(tcfg)
    jstate, jm = jax.jit(j_ts.make_train_step(jcfg, q_block=8)[0])(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    tstate, tm = t_ts.make_train_step(tcfg, q_block=8, mesh=mesh)[0](
        tstate, batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-4
    got = convert.train_state_to_numpy(tstate)
    for k, w in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        g = got.params
        for p in k:
            g = g[p.key]
        assert np.abs(g - np.asarray(w)).max() < 5e-4, k
    (one, m1), (sh, m2) = _step_both(tcfg, 4, 2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    a, b = _params(one), _params(sh)
    assert max(float((a[k] - b[k]).abs().max()) for k in a) < 5e-4


def test_phi4_2x2_microbatched_step_equals_one_device():
    """phi4-mini smoke (heads and kv heads over "model", tied vocabulary
    over "model") with microbatch 2: each row block split over "data"."""
    cfg = t_configs.get_config("phi4-mini-3.8b", smoke=True).replace(
        microbatch=2)
    (one, m1), (sh, m2) = _step_both(cfg, 2, 2, _batch(cfg))
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= \
        1e-5 * abs(float(m1["loss"]))
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= \
        1e-5 * abs(float(m1["grad_norm"]))
    a, b = _params(one), _params(sh)
    for k in a:
        assert bool(((a[k] - b[k]).abs() <= _param_tol(cfg, a[k])).all()), k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_family_runs_on_4x1(family):
    """Data parallelism plus FSDP (every large dim gathered at use): the
    loss within 1e-4 of one device's, parameters within 5e-4 (bf16
    parameters within a bf16 step more)."""
    cfg = _family_cfg(family)
    (one, m1), (sh, m2) = _step_both(cfg, 4, 1, _batch(cfg))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    a, b = _params(one), _params(sh)
    for k in a:
        assert bool(((a[k] - b[k]).abs() <= _param_tol(cfg, a[k])).all()), k


@pytest.mark.parametrize("family", ["vlm", "encdec", "audio"])
def test_vlm_and_encoder_decoder_are_tensor_parallel_on_2x2(family):
    """The families that reuse the dense attention and MLP on a "model"
    axis of 2: loss within 1e-4 of one device's, parameters within
    5e-4."""
    cfg = _family_cfg(family)
    (one, m1), (sh, m2) = _step_both(cfg, 2, 2, _batch(cfg))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    a, b = _params(one), _params(sh)
    for k in a:
        assert bool(((a[k] - b[k]).abs() <= _param_tol(cfg, a[k])).all()), k


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_moe_ssm_and_hybrid_families_run_on_2x2(family):
    """The three families once refused on a "model" axis wider than one
    are refused no more: their 2 x 2 step (experts, the SSM's
    projections, the hybrid's attention and SSM over "model") is within
    1e-4 of one device's loss and 5e-4 of its parameters."""
    cfg = _family_cfg(family)
    (one, m1), (sh, m2) = _step_both(cfg, 2, 2, _batch(cfg))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    a, b = _params(one), _params(sh)
    for k in a:
        assert bool(((a[k] - b[k]).abs() <= _param_tol(cfg, a[k])).all()), k


def test_mesh_step_is_bitwise_repeatable():
    cfg = t_configs.get_config("granite-20b", smoke=True)
    batch = _batch(cfg, seed=1)
    runs = []
    for _ in range(2):
        _, sh, mesh = _states(cfg, 2, 2)
        sh, m = t_ts.make_train_step(cfg, q_block=8, mesh=mesh)[0](sh, batch)
        runs.append((float(m["loss"]), _params(sh)))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def test_residual_spec_gives_the_same_loss():
    """The "residual" activation spec stores each layer carry in
    sequence pieces on the "model" devices; the numbers do not change."""
    cfg = t_configs.get_config("phi4-mini-3.8b", smoke=True)
    batch = _batch(cfg)
    out = []
    for act in ({}, {"residual": ("data", "model", None),
                     "attn_q": ("data", None, "model", None),
                     "attn_kv": ("data", None, "model", None)}):
        _, sh, mesh = _states(cfg, 2, 2)
        partition.reset_traffic()
        with t_ctx.activation_specs(act):
            sh, m = t_ts.make_train_step(cfg, q_block=8, mesh=mesh)[0](
                sh, batch)
        out.append((float(m["loss"]), _params(sh),
                    partition.TRAFFIC["crossed_bytes"]))
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * abs(out[0][0])
    for k in out[0][1]:
        torch.testing.assert_close(out[0][1][k], out[1][1][k], rtol=0,
                                   atol=1e-6)
    assert out[1][2] > out[0][2]        # the pieces crossed devices
    with t_ctx.activation_specs({"attn_q": ("data", None, None, None)}):
        _, sh, mesh = _states(cfg, 2, 2)
        with pytest.raises(ValueError, match="tensor-parallel layout"):
            t_ts.make_train_step(cfg, q_block=8, mesh=mesh)[0](sh, batch)


# --------------------------------------------------------------------------
# builders, checkpoints, the launcher
# --------------------------------------------------------------------------

def _run_cell(cfg, d, m, shape, model):
    """One builder's fn on real arguments placed by its in_specs."""
    mesh = t_mesh.make_lm_mesh(d, m, devices=[CPU] * (d * m))
    fn, args, insh, outsh, donate = t_builders.build_cell(cfg, mesh, shape)
    spec = lambda tree: {k: v.spec for k, v in tree.items()}  # noqa: E731
    if shape.kind == "train":
        st = t_ts.place_train_state(
            mesh, t_ts.init_train_state(cfg, copy.deepcopy(model)))
        b = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, shape, 1).items()}
        st, met = fn(st, partition.place(mesh, b, spec(insh[1])))
        assert outsh[1].spec == () and donate == (0,)
        return float(met["loss"]), _params(st)
    mdl = partition.place(mesh, copy.deepcopy(model), spec(insh[0]))
    if shape.kind == "prefill":
        b = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, shape, 2).items() if k != "labels"}
        out = fn(mdl, partition.place(mesh, b, spec(insh[1])))
        assert out.spec == outsh.spec
        return out.gather(CPU)
    cache = partition.place(mesh, tt.init_cache(cfg, shape.global_batch,
                                                shape.seq_len, device=CPU),
                            spec(insh[4]))
    tok = (torch.arange(shape.global_batch, dtype=torch.int32) * 7 + 3)[
        :, None]
    toks = []
    for p in range(6):
        t, cache = fn(mdl, rng.PRNGKey(p),
                      partition.place(mesh, tok, insh[2].spec), p, cache)
        tok = t.gather(CPU)[:, None]
        toks.append(tok[:, 0].tolist())
    return toks


@pytest.mark.parametrize("arch", ["granite-20b", "phi4-mini-3.8b"])
def test_build_cell_train_prefill_decode_on_2x2(arch):
    """The mirror of the reference's builders test: train, prefill and
    decode cells of granite smoke (MQA: a cache split on the sequence)
    and phi4 smoke (a cache split on kv heads) on a 2 x 2 mesh against a
    1 x 1 mesh: loss within 1e-4 and parameters within 5e-4, prefill
    logits within 1e-5 of the largest, decode tokens equal."""
    cfg = t_configs.get_config(arch, smoke=True).replace(microbatch=2)
    model = tt.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    shapes = (ShapeCfg("t", 64, 8, "train"), ShapeCfg("p", 64, 4, "prefill"),
              ShapeCfg("d", 64, 4, "decode"))
    mesh = t_mesh.make_lm_mesh(2, 2, devices=[CPU] * 4)
    layout = t_builders.build_cell(cfg, mesh, shapes[2])[2][4]["k"].spec
    assert layout == ((None, "data", "model", None, None)
                      if cfg.n_kv == 1 else
                      (None, "data", None, "model", None))
    a = [_run_cell(cfg, 1, 1, s, model) for s in shapes]
    b = [_run_cell(cfg, 2, 2, s, model) for s in shapes]
    assert abs(a[0][0] - b[0][0]) < 1e-4
    assert max(float((a[0][1][k] - b[0][1][k]).abs().max())
               for k in a[0][1]) < 5e-4
    assert float((a[1] - b[1]).abs().max()) <= 1e-5 * float(a[1].abs().max())
    assert a[2] == b[2]


def test_restore_with_reshard_and_the_restored_step(tmp_path):
    """A state saved on 2 x 2 restores onto 4 x 1 and one device bit for
    bit (the mirror of the reference's reshard test); on 2 x 2 the
    restored state's next step equals the live one's bit for bit, also
    after a reload through StepGuard."""
    cfg = t_configs.get_config("phi4-mini-3.8b", smoke=True)
    _, live, mesh = _states(cfg, 2, 2)
    step, _ = t_ts.make_train_step(cfg, q_block=8, mesh=mesh)
    live, _ = step(live, _batch(cfg, 0))
    save(str(tmp_path), 1, live)
    snap = convert.train_state_to_numpy(live)
    for d, m in ((4, 1), (1, 1)):
        other = t_ts.init_train_state(cfg, tt.init_model(
            cfg, torch.Generator().manual_seed(5), device=CPU))
        target = t_mesh.make_lm_mesh(d, m, devices=[CPU] * (d * m))
        other, at = restore(str(tmp_path), other, mesh=target)
        assert at == 1 and other.model.mesh is target
        got = convert.train_state_to_numpy(other)
        for x, y in zip(jax.tree.leaves(snap), jax.tree.leaves(got)):
            np.testing.assert_array_equal(x, y)
    back = t_ts.place_train_state(mesh, t_ts.init_train_state(
        cfg, tt.init_model(cfg, torch.Generator().manual_seed(7),
                           device=CPU)))
    guard = elastic.StepGuard(
        reload_fn=lambda: restore(str(tmp_path), back)[0])
    back = guard.reload_fn()
    nb = _batch(cfg, 1)
    live, m1 = step(live, nb)
    back, m2 = guard.run(step, back, nb)
    assert float(m1["loss"]) == float(m2["loss"])
    a, b = _params(live), _params(back)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_launcher_runs_a_2x2_mesh_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train

    train.main(["--arch", "phi4-mini-3.8b", "--smoke", "--mesh", "2x2",
                "--devices", "4", "--device", "cpu", "--steps", "2",
                "--seq-len", "16", "--batch", "4", "--ckpt-dir",
                str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "mesh {'data': 2, 'model': 2} over 4 devices (cpu)" in out
    assert "step 0: loss=" in out and "training done; retries: 0" in out
    from repro_torch.training import latest_step
    assert latest_step(str(tmp_path)) == 2
    with pytest.raises(SystemExit, match="--devices"):
        train.main(["--arch", "phi4-mini-3.8b", "--smoke", "--mesh", "2x2",
                    "--device", "cpu", "--steps", "1"])
