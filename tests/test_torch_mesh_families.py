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

A decode step updates the SSM state where ``cache_specs`` keep it: the
step's bytes between positions, by segment and kind, equal a reckoning
from the shapes and the layouts that holds no block of ``ssm_h`` or
``ssm_conv`` (the new token's columns a position lacks, under segment
"ssm_state"; the projections' input and partial sums; the weights each
position reads and does not store), so no copy carries one.  The
conv split on channels is bitwise the whole conv.

Tolerances: the reference's ``tests/test_distributed.py`` (loss within
1e-4, parameters within 5e-4 after one step; a bfloat16 parameter also
one bf16 step of its size, as ``tests/test_torch_sharding.py``), and
``tests/test_torch_models.py``'s for logits (within 1e-5 of the largest,
greedy tokens equal)."""
import _threads  # noqa: F401  (torch threads under xdist)
import copy
from collections import Counter

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
from repro_torch.models import ssm as ssm_lib  # noqa: E402
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


def _axes(spec) -> set:
    return {a for e in spec for a in ((e,) if isinstance(e, str)
                                      else (e or ()))}


def _stored(spec, nbytes: int, d: int, m: int, i: int, j: int) -> int:
    """Bytes of a leaf of ``nbytes`` that mesh position (i, j) stores: a
    block where the spec names the axis, else the replica kept at index
    0 of it."""
    ax = _axes(spec)
    if ("data" not in ax and i) or ("model" not in ax and j):
        return 0
    return nbytes // (d if "data" in ax else 1) // (m if "model" in ax else 1)


def _read_bytes(spec, nbytes: int, d: int, m: int, how: str) -> int:
    """What the batch shards' reads of a leaf receive: block j on "model"
    device j ("pieces") or the whole leaf at home ("home"), less what the
    reading position stores."""
    if how == "pieces":
        return sum(nbytes // m - _stored(spec, nbytes, d, m, i, j)
                   for i in range(d) for j in range(m))
    return sum(nbytes - _stored(spec, nbytes, d, m, i, 0) for i in range(d))


def _ssm_columns(cfg, m: int, proj_split: list, split: dict) -> int:
    """The new token's columns the "model" positions of one batch shard
    receive in one SSM layer's decode: each conv block's input
    (projection columns d_inner + its channels), and each head block's
    x, B and C (conv outputs), dt and z (projection columns), less what
    the position holds.  ``proj_split``: whether each projection (fused,
    or z, x, B, C, dt) is split over "model"."""
    di, gn, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.n_ssm_heads
    p, c = di // h, di + 2 * gn
    widths = ((di, di, gn, gn, h) if cfg.ssm_split_proj
              else (2 * di + 2 * gn + h,))
    held = [set() for _ in range(m)]
    off = 0
    for w, cut in zip(widths, proj_split):
        k = m if cut else 1
        for j in range(k):
            held[j] |= set(range(off + j * w // k, off + (j + 1) * w // k))
        off += w
    cols = 0
    kc = m if split["conv"] else 1
    conv_at = {}
    for j in range(kc):
        chans = range(j * c // kc, (j + 1) * c // kc)
        cols += len({di + x for x in chans} - held[j])
        conv_at.update({x: j for x in chans})
    kh = m if split["h"] else 1
    for j in range(kh):
        h0, h1 = j * h // kh, (j + 1) * h // kh
        cols += sum(conv_at[x] != j for x in
                    set(range(h0 * p, h1 * p)) | set(range(di, c)))
        cols += len((set(range(2 * di + 2 * gn + h0, 2 * di + 2 * gn + h1))
                     | set(range(h0 * p, h1 * p))) - held[j])
    return cols


def _decode_reckoning(cfg, model, specs: dict, shape, b: int,
                      split: dict) -> dict:
    """The bytes a decode step of an SSM or hybrid model copies between
    mesh positions, by (segment, kind), from the shapes and the layouts:
    the batch to the shards, the vocabulary-parallel embedding and head
    (tokens and hidden state out, partial sums and logit blocks home),
    the logits home; per layer and batch shard, each tensor-parallel
    op's input out and partial sums home, the SSM's new-token columns
    (segment "ssm_state"), and every weight read where it is not stored
    (float32, as stored), a conv or head block reading its slice of the
    replicated conv weights and head scalars; nothing of the SSM
    state."""
    d, m = shape
    e = 4 if cfg.dtype == "float32" else 2
    r, dm, v, nl = b // d, cfg.d_model, cfg.vocab, cfg.n_layers
    leaves = tt.param_leaves(model)
    want: Counter = Counter()

    def tp(k, dim=None):
        sp = specs[k]
        return "model" in (_axes(sp) if dim is None else _axes((sp[dim],)))

    def read(k, how, seg):
        t = leaves[k]
        n = nl if isinstance(t, list) else 1
        per = (t[0] if isinstance(t, list) else t).numel() * 4
        want[seg, "gather"] += n * _read_bytes(specs[k], per, d, m, how)

    def tensor_parallel():         # a layer's op, its input out, sums home
        want["layer", "broadcast"] += nl * d * (m - 1) * r * dm * e
        want["layer", "partial sum"] += nl * d * (m - 1) * r * dm * e

    want["step", "input"] += b * 4
    if tp("embed/tok", 0):
        read("embed/tok", "pieces", "step")
        want["step", "broadcast"] += d * (m - 1) * r * 4
        want["step", "partial sum"] += d * (m - 1) * r * dm * 4
    else:
        read("embed/tok", "home", "step")
    read("final_norm/scale", "home", "step")
    head, vdim = (("embed/tok", 0) if cfg.tie_embeddings
                  else ("embed/head", 1))
    if tp(head, vdim):
        read(head, "pieces", "step")
        want["step", "broadcast"] += d * (m - 1) * r * dm * e
        want["step", "reshard"] += d * (m - 1) * r * (v // m) * e
    else:
        read(head, "home", "step")
    want["step", "reshard"] += (d - 1) * r * v * e

    read("layers/ln1/scale", "home", "layer")
    names = (["layers/ssm/" + n for n in ("z_proj", "x_proj", "b_proj",
                                          "c_proj", "dt_proj")]
             if cfg.ssm_split_proj else ["layers/ssm/in_proj"])
    for k in names:
        read(k, "pieces" if tp(k) else "home", "layer")
    if any(tp(k) for k in names):
        want["layer", "broadcast"] += nl * d * (m - 1) * r * dm * e
    for k, f in (("conv_w", "conv"), ("conv_b", "conv"), ("a_log", "h"),
                 ("dt_bias", "h"), ("d_skip", "h")):
        # the slice a block reads, from the replica at (0, 0)
        blocks = m if split[f] else 1
        per = leaves["layers/ssm/" + k][0].numel() * 4 // blocks
        want["layer", "gather"] += nl * per * (d * blocks - 1)
    if tp("layers/ssm/out_proj"):
        assert split["h"], "the reckoning takes head blocks as out_proj's"
        read("layers/ssm/out_proj", "pieces", "layer")
        want["layer", "partial sum"] += nl * d * (m - 1) * r * dm * e
    else:
        read("layers/ssm/out_proj", "home", "layer")
    cols = _ssm_columns(cfg, m, [tp(k) for k in names], split)
    want["ssm_state", "reshard"] += nl * d * cols * r * e
    if cfg.family == "hybrid":
        assert cfg.n_kv % m == 0, "the reckoning takes kv heads over model"
        read("layers/ln2/scale", "home", "layer")
        for k in ("wq", "wk", "wv", "wo"):
            read("layers/attn/" + k, "pieces", "layer")
        tensor_parallel()
        mlp = [k for k in ("wi", "wg", "wo") if "layers/mlp/" + k in leaves]
        for k in mlp:
            read("layers/mlp/" + k, "pieces", "layer")
        tensor_parallel()
    return {k: n for k, n in want.items() if n}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_prefill_and_decode_equal_one_device(case):
    """The builders' prefill and decode cells on the mesh against the
    unplaced model on one device: prefill logits and 5 decode steps'
    logits within 1e-5 of the largest, the greedy tokens equal, and the
    SSM state split over "model" on the dims stated.  For the SSM and
    hybrid models each decode step's bytes by segment and kind are the
    reckoning's, which holds no byte of the SSM state: a copy of a
    state block would add bytes the reckoning lacks."""
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
    reckoned = (_decode_reckoning(cfg, one, {k: v.spec for k, v in
                                             insh[0].items()}, shape, b,
                                  split) if split else None)
    ref = tt.init_cache(cfg, b, steps, device=CPU)
    tok = toks[:, :1]
    for p in range(steps):
        partition.reset_traffic()
        got, cache = dec(placed, rng.PRNGKey(p), tok, p, cache)
        want, ref = tt.decode_step(one, tok, p, ref)
        _close(got, want.float())
        tok = torch.argmax(got, -1).to(torch.int32)[:, None]
        assert torch.equal(tok, torch.argmax(want, -1).to(torch.int32)[
            :, None])
        if reckoned is not None:
            assert {k: v[1] for k, v in partition.KINDS.items()} == reckoned
            assert partition.TRAFFIC["crossed_bytes"] == sum(
                reckoned.values())
    for name in ref:
        _close(partition.gather(cache[name], CPU).float(), ref[name].float())


@pytest.mark.parametrize("case", sorted(k for k, v in SERVE_CASES.items()
                                        if v[3]))
def test_split_conv_is_bitwise_the_whole_conv(case):
    """One layer's decode conv on the conv state's blocks where
    ``cache_specs`` keep them (``ssm.conv_blocks``), from the projections'
    column blocks: its output and new state bitwise the whole conv's
    (``_causal_conv``) on the joined input and state."""
    arch, kw, shape, split = SERVE_CASES[case]
    cfg = t_configs.get_config(arch, smoke=True).replace(**kw)
    mesh = _mesh(shape)
    b = 4
    model = tt.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    _, _, insh, _, _ = builders.build_decode(
        cfg, mesh, ShapeCfg("d", 8, b, "decode"), sampler=None)
    placed = partition.place(mesh, copy.deepcopy(model),
                             {k: v.spec for k, v in insh[0].items()})
    gen = np.random.default_rng(3)
    cache = tt.init_cache(cfg, b, 8, device=CPU)
    cache["ssm_conv"].copy_(torch.from_numpy(gen.standard_normal(
        cache["ssm_conv"].shape).astype(np.float32)))
    whole_state = cache["ssm_conv"][0].clone()
    cache = partition.place(mesh, cache,
                            {k: v.spec for k, v in insh[4].items()})
    u = torch.from_numpy(gen.standard_normal(
        (b // shape[0], 1, cfg.d_model)).astype(np.float32))
    run = partition.MeshRun(mesh, insh[4]["ssm_conv"].spec[1])
    lp, di = placed.layers[0].ssm, cfg.d_inner
    names = (("z_proj", "x_proj", "b_proj", "c_proj", "dt_proj")
             if cfg.ssm_split_proj else ("in_proj",))
    with run.scope(), run.on(0), torch.no_grad():
        zx, off = [], 0
        for blocks in ssm_lib._in_projection_blocks(lp, names, u):
            for j, t in blocks:
                zx.append((off, off + t.shape[-1], j, t))
                off += t.shape[-1]
        blocks = tt._ssm_blocks(run, cache, 0, 0)["conv"]
        assert len(blocks) == (shape[1] if split["conv"] else 1)
        out, new_blocks = ssm_lib.conv_blocks(lp, cfg, zx, blocks)
        joined = torch.cat([t for _, _, _, t in zx], dim=-1)
        rows = slice(0, b // shape[0])
        y, new = ssm_lib._causal_conv(
            joined[..., di: di + out[-1][1]], lp.w("conv_w", u.dtype),
            lp.w("conv_b", u.dtype), whole_state[rows])
    assert torch.equal(torch.cat([t for _, _, _, t in out], dim=-1), y)
    assert torch.equal(torch.cat(new_blocks, dim=-1), new)
