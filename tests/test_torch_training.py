"""The port's training path against the JAX package on the CPU: data,
optimizers and int8 compression on equal gradients (stacked leaves
included), microbatched train steps, checkpoints across the two
packages, the fault-tolerance hooks and the launcher.

Weights and optimizer state are the reference's, carried over by
``convert.train_state_from_numpy``; gradients and batches are made with
numpy from a seed.  Tolerances are stated where they are used."""
import _threads  # noqa: F401  (torch threads under xdist)
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro import training as j_training  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import train_step as j_ts  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import training as t_training  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.training import elastic as t_elastic  # noqa: E402
from repro_torch.training import optimizer as t_opt  # noqa: E402
from repro_torch.training import train_step as t_ts  # noqa: E402

CPU = torch.device("cpu")
# the optimizer kinds: adamw (phi4-mini), adamw_bf16 (qwen1.5-32b, bf16
# moments), adafactor (grok-1-314b: bf16 parameters, stacked norm scales
# factored over the layers)
OPT_ARCHS = {"adamw": "phi4-mini-3.8b", "adamw_bf16": "qwen1.5-32b",
             "adafactor": "grok-1-314b"}


def _cfgs(arch, **kw):
    j = j_configs.get_config(arch, smoke=True).replace(**kw)
    t = t_configs.get_config(arch, smoke=True).replace(**kw)
    return j, t


def _ref_state(jcfg, seed=0):
    params = jt.init_model(jax.random.PRNGKey(seed), jcfg)
    return j_ts.init_train_state(jcfg, params)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate, tcfg):
    return convert.train_state_from_numpy(_to_numpy(jstate), tcfg,
                                          device=CPU)


def _flat(tree):
    """Leaf path -> float32 numpy array (bf16 exactly), reference keys."""
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ulps(got, want, bf16: bool) -> np.ndarray:
    """|got - want| in units of the last place of ``want`` (float32, or
    bfloat16: 2**16 float32 places)."""
    sp = np.spacing(np.abs(want).astype(np.float32)) * (65536 if bf16 else 1)
    return np.abs(got.astype(np.float64) - want) / sp


def _dtypes(jstate):
    return {jax.tree_util.keystr(p): np.asarray(x).dtype.name == "bfloat16"
            for p, x in jax.tree_util.tree_flatten_with_path(jstate)[0]}


def _state_ulps(tstate, jstate) -> dict:
    """Largest difference in ulps, leaf by leaf, of the port's state (as
    the reference's numpy tree) against the reference's."""
    got = _flat(convert.train_state_to_numpy(tstate))
    want = _flat(jstate)
    bf16 = _dtypes(jstate)
    assert sorted(got) == sorted(want)
    return {k: float(_ulps(got[k], want[k], bf16[k]).max(initial=0.0))
            for k in want}


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_token_dataset_and_make_batch_equal_the_reference(tmp_path):
    from repro.configs.base import ShapeCfg as JShape
    from repro.training import data as j_data
    from repro_torch.configs.base import ShapeCfg as TShape
    from repro_torch.training import data as t_data

    for path in (None, str(tmp_path / "tokens.bin")):
        if path:
            t_data.write_token_file(path, 5000, 1000, seed=4)
            with open(path, "rb") as f:
                mine = f.read()
            j_data.write_token_file(path + ".ref", 5000, 1000, seed=4)
            with open(path + ".ref", "rb") as f:
                assert f.read() == mine
        jd = j_training.TokenDataset(j_training.DataConfig(1000, 32, 4, 9,
                                                           path))
        td = t_training.TokenDataset(t_training.DataConfig(1000, 32, 4, 9,
                                                           path))
        for step in (0, 5):
            want, got = jd.batch_at(step), td.batch_at(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
        assert next(td.iterate(5))["tokens"].tolist() == \
            jd.batch_at(5)["tokens"].tolist()
    for arch in ("pixtral-12b", "seamless-m4t-medium"):
        jcfg, tcfg = _cfgs(arch)
        want = j_data.make_batch(jcfg, JShape("t", 16, 2, "train"), 3)
        got = t_data.make_batch(tcfg, TShape("t", 16, 2, "train"), 3)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------------
# optimizers on equal gradients
# --------------------------------------------------------------------------

def _grads(jstate, seed, scale):
    """Gradients of the parameters' shapes and dtypes: normal draws times
    ``scale``, with every fifth element zero.  ``scale=None``: signs
    times 0.5, whose squares sum exactly in any order.  ``scale="exact"``:
    random signs times 2**-10 (leaves of ndim >= 2: 2**-11 where the index
    on axis 0 is odd, so stacked leaves alternate by layer), no zeros:
    every sum of squares, row and column mean, and mean of means that
    Adafactor takes is exact in any order."""
    r = np.random.default_rng(seed)

    def one(p):
        if scale == "exact":
            mag = np.full(p.shape, 2.0 ** -10)
            if p.ndim >= 2:
                mag[1::2] = 2.0 ** -11
            g = np.where(r.random(p.shape) < 0.5, -mag, mag)
        elif scale is None:
            g = np.where(r.random(p.shape) < 0.5, -0.5, 0.5)
        else:
            g = r.standard_normal(p.shape) * scale
        g = g.astype(np.float32)
        if scale != "exact":
            g.reshape(-1)[::5] = 0.0
        return jnp.asarray(g).astype(p.dtype)

    return jax.tree.map(one, jstate.params)


def _port_grads(jgrads, tstate):
    """The reference's gradient tree as the port's per-layer leaves."""
    flat = {"/".join(str(k.key) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    out = {}
    for key, p in tt.param_leaves(tstate.model).items():
        g = convert._tensor(flat[key])
        out[key] = list(g.unbind(0)) if isinstance(p, list) else g
    return out


def _factored_moments64(jg, jstate, jn):
    """Adafactor's new factored moments (``vr``, ``vc`` of leaves of ndim
    >= 2) recomputed from the reference's inputs with the means taken in
    float64: the elementwise float32 steps as both packages take them,
    then ``beta * v + (1 - beta) * mean`` without rounding."""
    step = int(jstate.opt.step) + 1
    beta = 1.0 - float(np.float32(step) ** np.float32(-0.8))
    scale = np.float32(min(1.0, 1.0 / max(float(jn), 1e-12)))
    out = {}
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        if g.ndim < 2:
            continue
        key = jax.tree_util.keystr(path)
        g = np.asarray(g.astype(jnp.float32)) * scale
        g2 = (g * g + np.float32(1e-30)).astype(np.float64)
        for name, axis in (("vr", -1), ("vc", -2)):
            prev = np.asarray(getattr(jstate.opt, name)
                              [path[0].key][path[1].key][path[2].key]
                              if len(path) == 3 else
                              getattr(jstate.opt, name)[path[0].key]
                              [path[1].key], np.float64)
            out[f".opt.{name}{key}"] = beta * prev + (1 - beta) * g2.mean(
                axis)
    return out


# Adafactor's factored moments on normal gradients, in float32 ulps from the
# same moments with the means taken in float64 (row and column means of
# float32 squares, summed in each package's own order): the port's within
# PORT_MEAN_ULPS (measured at most 2.26), the reference's within
# REF_MEAN_ULPS (measured at most 5.36: its sums of the clipped step's
# equal squares drift), and the two within PAIR_MEAN_ULPS of each other
# (measured at most 6)
PORT_MEAN_ULPS, REF_MEAN_ULPS, PAIR_MEAN_ULPS = 4.0, 6.0, 8.0


@pytest.mark.parametrize("kind", list(OPT_ARCHS))
def test_optimizer_updates_match_reference(kind):
    """Updates on the same gradients, each starting from the reference's
    state: first one on ``_grads(..., "exact")`` (step 1), then, from the
    initial state again, three in a row: two below the clip (global norm
    < 1, so the clip scale is exactly 1) and one far above it with
    gradients of ±0.5, whose global norm both packages compute exactly.

    * global norm: equal where its squares sum exactly, within 1e-5
      relative on normal gradients (float32 sums in another order);
    * AdamW moments (float32 or bf16) and parameters: within 1 ulp
      (measured: bit for bit);
    * Adafactor on the exact-sum gradients: moments and parameters within
      1 ulp (float32, or bf16 for grok's bf16 parameters).  The stacked
      (L, d) norm scales are factored over the layers, and their two
      layers' gradients differ, so ``r`` is not 1 there;
    * Adafactor on normal gradients: parameters within 1 ulp; the factored
      moments are row and column means of float32 squares, which the two
      packages sum in different orders.  Each package's moments are held
      to the same moments with the means taken in float64 (the cause
      shown: the port within ``PORT_MEAN_ULPS``, the reference within
      ``REF_MEAN_ULPS``), and the two within ``PAIR_MEAN_ULPS`` of each
      other; unfactored ones within 1 ulp.

    Adafactor covers the stacked (L, d) norm scales it factors over the
    layers and its update clip over whole stacks."""
    jcfg, tcfg = _cfgs(OPT_ARCHS[kind])
    assert jcfg.optimizer == kind
    jstate0 = _ref_state(jcfg)
    jo, to = j_opt.make_optimizer(jcfg), t_opt.make_optimizer(tcfg)
    if kind == "adafactor":
        assert jstate0.opt.vc["layers"]["ln1"]["scale"].shape == (
            jcfg.d_model,)
    bf16 = _dtypes(jstate0)
    jstate = jstate0
    seen = {"port": 0.0, "reference": 0.0, "pair": 0.0}
    for i, scale in enumerate(("exact", 1e-3, 2e-4, None)):
        if scale == "exact":
            jstate = jstate0
        tstate = _port_state(jstate, tcfg)
        jg = _grads(jstate, i, scale)
        jp, jopt, jn = jo.update(jg, jstate.opt, jstate.params)
        exact64 = (_factored_moments64(jg, jstate, jn)
                   if kind == "adafactor" and scale != "exact" else {})
        _, tstate.opt, tn = to.update(_port_grads(jg, tstate), tstate.opt,
                                      tt.param_leaves(tstate.model))
        jstate = j_ts.TrainState(jp, jopt, jstate.step)
        assert (float(jn) < 1.0) == (scale is not None)
        assert abs(float(tn) - float(jn)) <= (
            1e-5 * float(jn) if isinstance(scale, float) else 0.0)
        got = _flat(convert.train_state_to_numpy(tstate))
        for k, w in _flat(jstate).items():
            u = float(_ulps(got[k], w, bf16[k]).max(initial=0.0))
            if k in exact64:
                for who, v, bound in (("port", got[k], PORT_MEAN_ULPS),
                                      ("reference", w, REF_MEAN_ULPS)):
                    e = float(_ulps(v, exact64[k], False).max(initial=0.0))
                    assert e <= bound, (i, k, bound, e)
                    seen[who] = max(seen[who], e)
                assert u <= PAIR_MEAN_ULPS, (i, k, u)
                seen["pair"] = max(seen["pair"], u)
            else:
                assert u <= 1.0, (i, k, u)
        if scale == "exact":
            jstate = jstate0
    if kind == "adafactor":
        print("factored moments, largest ulps from the float64 means:", seen)


def test_sqrt_is_rounded_once_as_the_reference_rounds_it():
    """``core.fixedpoint.sqrt`` (the optimizers' root) of a large float32
    tensor on the CPU equals numpy's and XLA's correctly rounded root bit
    for bit; torch's own CPU root of such a tensor is MKL's, which is not
    always correctly rounded (the count is printed)."""
    from repro_torch.core.fixedpoint import sqrt

    x = (np.random.default_rng(5).random(1 << 16) * 1e-6).astype(np.float32)
    want = np.sqrt(x)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(x)), want)
    np.testing.assert_array_equal(sqrt(torch.from_numpy(x)).numpy(), want)
    print("torch.sqrt differs on",
          int((torch.sqrt(torch.from_numpy(x)).numpy() != want).sum()),
          "of", x.size)


def test_cosine_lr_and_global_norm_match_reference():
    """The schedule through warm-up, the cosine and the floor, bit for
    bit; the global norm of stacked and unstacked leaves within 1e-6
    relative (float32 sums in another order)."""
    steps = np.array([0, 1, 7, 999, 1000, 1001, 5000, 99_999, 100_000,
                      250_000], np.int32)
    for kw in ({}, {"base": 1e-3, "warmup": 10, "total": 100}):
        want = np.asarray(j_opt.cosine_lr(jnp.asarray(steps), **kw))
        got = t_opt.cosine_lr(torch.from_numpy(steps), **kw).numpy()
        np.testing.assert_array_equal(got, want)
    jcfg, tcfg = _cfgs("hymba-1.5b")
    jstate = _ref_state(jcfg)
    tstate = _port_state(jstate, tcfg)
    jg = _grads(jstate, 11, 1e-2)
    want = float(j_opt.global_norm(jg))
    got = float(t_opt.global_norm(_port_grads(jg, tstate)))
    assert abs(got - want) <= 1e-6 * want


def test_compress_grads_int8_matches_reference():
    """One scale over each stacked leaf (its largest |g| may lie in
    either layer), leaves of at most 1024 elements unchanged, float32
    and bfloat16 gradients: equal to the reference's, bit for bit."""
    jcfg, tcfg = _cfgs("grok-1-314b")
    jstate = _ref_state(jcfg)
    tstate = _port_state(jstate, tcfg)
    for dtype in (jnp.float32, jnp.bfloat16):
        jg = jax.tree.map(lambda g: g.astype(dtype),
                          _grads(jstate, 7, 1e-2))
        # put the largest |g| of the stacked wi in layer 1 only
        jg["layers"]["moe"]["wi"] = jg["layers"]["moe"]["wi"].at[1, 0, 0, 0] \
            .set(0.5)
        want = _flat(j_ts.compress_grads_int8(jg))
        got = t_ts.compress_grads_int8(_port_grads(jg, tstate))
        for key, g in got.items():
            g = (torch.stack(g) if isinstance(g, list) else g).float()
            np.testing.assert_array_equal(
                g.numpy(), want["['" + key.replace("/", "']['") + "']"],
                err_msg=key)
        small = got["layers/ln1/scale"]        # (2, 128): 256 elements
        assert small[0].dtype == torch.float32 or dtype == jnp.bfloat16


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def test_two_microbatched_train_steps_match_reference():
    """phi4-mini smoke with microbatch 2 (batch 4, 16 tokens): two steps
    through the reference's jitted step and the port's.  Losses within
    1e-5 relative; grad norms within 1e-5 relative.  Parameters within
    1e-6 absolute, except where a near-zero gradient took the other sign:
    AdamW's first step moves every element by about ±lr (3e-4) whatever
    its gradient's size, so such an element differs by about 2·lr.  At
    most 1 in 10,000 elements may, and by no more than 2.1·lr a step."""
    jcfg, tcfg = _cfgs("phi4-mini-3.8b", microbatch=2)
    jstate = _ref_state(jcfg, seed=2)
    tstate = _port_state(jstate, tcfg)
    jstep = jax.jit(j_ts.make_train_step(jcfg, q_block=8)[0])
    tstep, _ = t_ts.make_train_step(tcfg, q_block=8)
    ds = j_training.TokenDataset(j_training.DataConfig(jcfg.vocab, 16, 4))
    for i in range(2):
        batch = ds.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for name in ("loss", "grad_norm"):
            assert abs(float(tm[name]) - float(jm[name])) <= \
                1e-5 * abs(float(jm[name])), name
    got = _flat(convert.train_state_to_numpy(tstate).params)
    want = _flat(jstate.params)
    n = flipped = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        n += d.size
        flipped += int((d > 1e-6).sum())
        assert d.max() <= 2 * 2.1 * 3e-4, (k, d.max())
    assert flipped <= n // 10_000, (flipped, n)
    assert int(tstate.step) == 2 and int(tstate.opt.step) == 2


def test_microbatch_equals_full_batch():
    """The port's own identity (tests/test_training.py's): granite smoke in
    float32, microbatch 2 against the full batch, one step: parameters
    within 5e-5."""
    cfg = t_configs.get_config("granite-20b", smoke=True).replace(
        dtype="float32")
    model = tt.init_model(cfg, torch.Generator().manual_seed(1), device=CPU)
    ds = t_training.TokenDataset(t_training.DataConfig(cfg.vocab, 8, 4))
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
    states = {}
    for mb in (0, 2):
        c = cfg.replace(microbatch=mb)
        st = convert.train_state_from_numpy(
            convert.train_state_to_numpy(t_ts.init_train_state(c, model)), c,
            device=CPU)
        step, _ = t_ts.make_train_step(c, q_block=8)
        states[mb], _ = step(st, batch)
    a = tt.param_leaves(states[0].model)
    b = tt.param_leaves(states[2].model)
    for k in a:
        for x, y in zip(t_opt.as_list(a[k]), t_opt.as_list(b[k])):
            assert float((x - y).detach().abs().max()) < 5e-5, k


def test_memorizes_fixed_batch():
    cfg = t_configs.get_config("qwen1.5-32b", smoke=True).replace(
        microbatch=2)
    state = t_ts.init_train_state(cfg, device=CPU)
    step, _ = t_ts.make_train_step(cfg, q_block=8)
    ds = t_training.TokenDataset(t_training.DataConfig(cfg.vocab, 16, 4))
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
    losses = []
    for _ in range(25):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.75 * losses[0]


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-32b", "grok-1-314b"])
def test_checkpoints_cross_between_the_packages(arch, tmp_path):
    """A reference checkpoint restores into a port state and a port
    checkpoint into a reference state, bit for bit: AdamW with bf16
    moments (qwen) and Adafactor with bf16 parameters (grok)."""
    jcfg, tcfg = _cfgs(arch)
    jstate = _ref_state(jcfg, seed=1)
    jstate = jstate._replace(step=jnp.int32(7),
                             opt=jstate.opt._replace(step=jnp.int32(7)))
    jg = _grads(jstate, 3, 1e-2)
    jp, jopt, _ = j_opt.make_optimizer(jcfg).update(jg, jstate.opt,
                                                    jstate.params)
    jstate = jstate._replace(params=jp, opt=jopt)   # moments not zero
    j_training.save(str(tmp_path / "j"), 7, jstate)
    other = t_ts.init_train_state(tcfg, tt.init_model(
        tcfg, torch.Generator().manual_seed(5), device=CPU))
    restored, step = t_training.restore(str(tmp_path / "j"), other)
    assert step == 7 and restored is other
    assert all(v == 0 for v in _state_ulps(restored, jstate).values())

    t_training.save(str(tmp_path / "t"), 9, restored)
    like = _ref_state(jcfg, seed=3)
    back, step = j_training.restore(str(tmp_path / "t"), like)
    assert step == 9
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, _flat(jstate)[k], err_msg=k)
    with open(tmp_path / "t" / "step_00000009" / "manifest.json") as f:
        mine = f.read()
    with open(tmp_path / "j" / "step_00000007" / "manifest.json") as f:
        assert f.read().replace('"step": 7', '"step": 9') == mine


def test_async_checkpointer_snapshots_before_the_next_in_place_step(
        tmp_path):
    """``save`` copies to host memory before it returns: the step that
    updates the state in place right after it does not reach the
    checkpoint.  An uncommitted ``.tmp`` is never the latest step, and
    the writer keeps the last ``keep`` steps."""
    cfg = t_configs.get_config("mamba2-130m", smoke=True)
    state = t_ts.init_train_state(cfg, device=CPU)
    step, _ = t_ts.make_train_step(cfg, q_block=8)
    ds = t_training.TokenDataset(t_training.DataConfig(cfg.vocab, 16, 2))
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
    before = convert.train_state_to_numpy(state)
    ck = t_training.AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(1, state)
    state, _ = step(state, batch)          # in place, while the writer runs
    ck.save(2, state)
    ck.save(3, state)
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert t_training.latest_step(str(tmp_path)) == 3
    ck1 = t_training.AsyncCheckpointer(str(tmp_path / "one"))
    ck1.save(1, t_ts.init_train_state(cfg, tt.init_model(
        cfg, torch.Generator().manual_seed(0), device=CPU)))
    ck1.wait()
    fresh = t_ts.init_train_state(cfg, device=CPU)
    for p in fresh.model.parameters():
        torch.nn.init.zeros_(p)
    t_training.restore(str(tmp_path / "one"), fresh)
    got = _flat(convert.train_state_to_numpy(fresh))
    for k, v in _flat(before).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# --------------------------------------------------------------------------
# fault tolerance, launcher
# --------------------------------------------------------------------------

class _State:
    dirty = False


def test_step_guard_retries_then_reloads():
    """Device errors are retried up to ``max_retries`` on a clean state;
    a state the failed attempt began to write is reloaded at once; other
    errors pass through untouched."""
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] < 3:
            raise torch.AcceleratorError("injected fault")
        return state, {"loss": torch.tensor(1.0)}

    g = t_elastic.StepGuard(max_retries=2, reload_fn=lambda: "fresh")
    out = g.run(flaky, _State(), None)
    assert float(out[1]["loss"]) == 1.0 and (g.retries, g.reloads) == (2, 0)

    reloaded = []

    def torn(state, batch):
        if state != "fresh":
            state.dirty = True             # a write was issued, then ...
            raise torch.AcceleratorError("fault mid-update")
        return state, {"loss": torch.tensor(2.0)}

    g = t_elastic.StepGuard(max_retries=2,
                            reload_fn=lambda: reloaded.append(1) or "fresh")
    out = g.run(torn, _State(), None)
    assert out[0] == "fresh" and (g.retries, g.reloads) == (1, 1)
    assert reloaded == [1]

    def bad(state, batch):
        raise ValueError("not a device fault")

    g = t_elastic.StepGuard(reload_fn=lambda: "fresh")
    with pytest.raises(ValueError):
        g.run(bad, _State(), None)
    assert g.retries == 0
    g = t_elastic.StepGuard(max_retries=1)
    with pytest.raises(torch.AcceleratorError):
        g.run(lambda s, b: (_ for _ in ()).throw(
            torch.AcceleratorError("x")), _State(), None)
    assert g.retries == 2


def test_step_guard_confirms_a_real_step():
    cfg = t_configs.get_config("mamba2-130m", smoke=True)
    state = t_ts.init_train_state(cfg, device=CPU)
    step, _ = t_ts.make_train_step(cfg, q_block=8)
    ds = t_training.TokenDataset(t_training.DataConfig(cfg.vocab, 8, 2))
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
    guard = t_training.StepGuard()
    state, m = guard.run(step, state, batch)
    assert state.dirty is False and int(state.step) == 1
    assert np.isfinite(float(m["loss"])) and guard.retries == 0


def test_straggler_detection_and_elastic_mesh():
    sd = t_training.StragglerDetector(threshold=4.0)
    for i in range(32):
        assert not sd.record(i, 1.0 + 0.02 * (i % 3))
    assert sd.record(99, 8.0)
    assert sd.flagged[-1][0] == 99
    m = t_training.elastic_mesh(model_parallel=4, devices=["cpu"] * 6)
    assert m.shape == {"data": 3, "model": 2}
    assert t_training.elastic_mesh(8, devices=["cpu"]).size == 1
    hb = t_training.Heartbeat(timeout_s=60.0)
    hb.beat()
    assert hb.healthy()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no devices"):
            t_training.elastic_mesh(2)


def test_train_launcher_runs_on_the_cpu_refuses_a_mesh_and_needs_a_card(
        capsys, tmp_path):
    from repro_torch.launch import train

    args = ["--arch", "mamba2-130m", "--smoke", "--steps", "3", "--seq-len",
            "16", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    train.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 0: loss=" in out and "gnorm=" in out
    assert "training done; retries: 0" in out
    assert t_training.latest_step(str(tmp_path)) == 2
    train.main(args + ["--device", "cpu", "--resume", "--steps", "1"])
    assert "resumed from step 2" in capsys.readouterr().out
    # the SSM family on a "model" axis wider than one
    # (tests/test_torch_mesh_families.py holds it against the reference)
    train.main(args + ["--device", "cpu", "--mesh", "1x2", "--devices", "2",
                       "--steps", "1", "--ckpt-dir", str(tmp_path / "m")])
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 2} over 2 devices (cpu)" in out
    assert "training done; retries: 0" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(args)
