"""The MoE, SSM and hybrid families on a ("data", "model") mesh whose
"model" axis is wider than one, on the CPU at smoke width in float32
compute: one train step against the reference's jitted step, and prefill
and decode against the port's one device.

The layouts are ``param_specs``'s and ``cache_specs``'s: grok-1 smoke's
two experts over "model" on 2 x 2 (expert parallel) and its expert ffn
over "model" on 1 x 4 (two experts do not split four ways); llama4
smoke's four experts on 2 x 2; mamba2 smoke's fused ``in_proj`` (Z 552)
split in two blocks across its z/x/B/C/dt segments; hymba smoke's
attention heads, MLP, ``in_proj`` or split projections on 2 x 2.  The
decode cases cover an SSM state split on heads and conv channels
(mamba2 2 x 2), on channels alone (1 x 3: 8 heads do not split three
ways) and on heads alone (1 x 4 with ``ssm_state`` 9: 274 channels do
not split four ways).

Tolerances: the reference's ``tests/test_distributed.py`` (loss within
1e-4, parameters within 5e-4 after one step; a bfloat16 parameter also
one bf16 step of its size, as ``tests/test_torch_sharding.py``), and
``tests/test_torch_models.py``'s for logits (within 1e-5 of the largest,
greedy tokens equal)."""
import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import train_step as j_ts  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.launch import builders  # noqa: E402
from repro_torch.launch.mesh import make_lm_mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.training import DataConfig, TokenDataset  # noqa: E402
from repro_torch.training import train_step as t_ts  # noqa: E402

CPU = torch.device("cpu")

# case -> (arch, config changes, mesh (data, model), the leaf and the
# dim of its layer spec that "model" must split)
STEP_CASES = {
    "grok1_experts_2x2": ("grok-1-314b", {}, (2, 2), ("layers/moe/wi", 0)),
    "grok1_ffn_1x4": ("grok-1-314b", {}, (1, 4), ("layers/moe/wi", 2)),
    "llama4_experts_2x2": ("llama4-scout-17b-a16e", {}, (2, 2),
                           ("layers/moe/wg", 0)),
    "mamba2_in_proj_2x2": ("mamba2-130m", {}, (2, 2),
                           ("layers/ssm/in_proj", 1)),
    "hymba_2x2": ("hymba-1.5b", {}, (2, 2), ("layers/ssm/in_proj", 1)),
    "hymba_split_proj_2x2": ("hymba-1.5b", {"ssm_split_proj": True},
                             (2, 2), ("layers/ssm/dt_proj", 1)),
}


def _mesh(shape):
    d, m = shape
    return make_lm_mesh(d, m, devices=[CPU] * (d * m))


def _batch(cfg, b=8, s=16):
    ds = TokenDataset(DataConfig(cfg.vocab, s, b))
    return {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}


def _param_tol(cfg, want):
    return 5e-4 + (2.0 ** -7 * np.abs(want)
                   if cfg.param_dtype == "bfloat16" else 0)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_mesh_step_equals_the_reference(case):
    """One train step of the port on the mesh against the reference's
    jitted step from the same state: loss within 1e-4, parameters within
    5e-4; the leaf named is split over "model" as stated, and the layer
    copied activations between "model" positions."""
    arch, kw, shape, (leaf, dim) = STEP_CASES[case]
    jcfg = j_configs.get_config(arch, smoke=True).replace(**kw)
    tcfg = t_configs.get_config(arch, smoke=True).replace(**kw)
    jstate = j_ts.init_train_state(jcfg, jt.init_model(
        jax.random.PRNGKey(0), jcfg))
    mesh = _mesh(shape)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, device=CPU, mesh=mesh)
    assert tt.param_leaves(tstate.model)[leaf][0].model_dim() == dim
    batch = _batch(tcfg)
    jstate, jm = jax.jit(j_ts.make_train_step(jcfg, q_block=8)[0])(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    partition.reset_traffic()
    tstate, tm = t_ts.make_train_step(tcfg, q_block=8, mesh=mesh)[0](
        tstate, batch)
    assert ("layer", "reshard") in partition.KINDS
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-4
    got = convert.train_state_to_numpy(tstate)
    for k, w in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        g = got.params
        for p in k:
            g = g[p.key]
        want = np.asarray(w, dtype=np.float32)
        assert (np.abs(g - want) <= _param_tol(tcfg, want)).all(), k


# case -> (arch, config changes, mesh, the SSM state's split dims of a
# layer block: "h" heads (1), "conv" channels (2), None whole)
SERVE_CASES = {
    "mamba2_heads_and_channels_2x2": ("mamba2-130m", {}, (2, 2),
                                      {"h": 1, "conv": 2}),
    "mamba2_channels_1x3": ("mamba2-130m", {}, (1, 3),
                            {"h": None, "conv": 2}),
    "mamba2_heads_1x4": ("mamba2-130m", {"ssm_state": 9}, (1, 4),
                         {"h": 1, "conv": None}),
    "hymba_2x2": ("hymba-1.5b", {}, (2, 2), {"h": 1, "conv": 2}),
    "llama4_experts_2x2": ("llama4-scout-17b-a16e", {}, (2, 2), {}),
    "grok1_ffn_1x4": ("grok-1-314b", {}, (1, 4), {}),
}


def _close(got, want, tol=1e-5):
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_prefill_and_decode_equal_one_device(case):
    """The builders' prefill and decode cells on the mesh against the
    unplaced model on one device: prefill logits and 5 decode steps'
    logits within 1e-5 of the largest, the greedy tokens equal, and the
    SSM state split over "model" on the dims stated."""
    arch, kw, shape, split = SERVE_CASES[case]
    cfg = t_configs.get_config(arch, smoke=True).replace(**kw)
    one = tt.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    mesh = _mesh(shape)
    b, s, steps = 4, 16, 5
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))

    pre, _, insh, _, _ = builders.build_prefill(
        cfg, mesh, ShapeCfg("p", s, b, "prefill"))
    placed = partition.place(mesh, copy.deepcopy(one),
                             {k: v.spec for k, v in insh[0].items()})
    got = pre(placed, partition.place(mesh, {"tokens": toks},
                                      {"tokens": insh[1]["tokens"].spec}))
    assert set(insh[1]) == {"tokens"}
    with torch.no_grad():
        want = unembed(one.embed, cfg, tt.forward(one, toks, q_block=8)[
            :, -1:])[:, 0].float()
    _close(got.gather(CPU), want)

    dec, _, insh, _, _ = builders.build_decode(
        cfg, mesh, ShapeCfg("d", steps, b, "decode"), sampler=None)
    cache = partition.place(mesh, tt.init_cache(cfg, b, steps, device=CPU),
                            {k: v.spec for k, v in insh[4].items()})
    for name, d in split.items():
        sh = cache["ssm_" + name]
        assert (None if sh.model_dim() is None else sh.model_dim() - 1) == d
    ref = tt.init_cache(cfg, b, steps, device=CPU)
    tok = toks[:, :1]
    for p in range(steps):
        got, cache = dec(placed, rng.PRNGKey(p), tok, p, cache)
        want, ref = tt.decode_step(one, tok, p, ref)
        _close(got, want.float())
        tok = torch.argmax(got, -1).to(torch.int32)[:, None]
        assert torch.equal(tok, torch.argmax(want, -1).to(torch.int32)[
            :, None])
    for name in ref:
        _close(partition.gather(cache[name], CPU).float(), ref[name].float())
