"""The port's LM path against the JAX package on the CPU: configs,
decode logits for every model family, forward (train/prefill) hidden
states, the int8 KV cache, MoE dispatch, greedy ``generate``, and the
training loss with its gradients under each remat policy.

Weights are the reference's own (``jax.random`` init), carried over by
``convert.lm_params_from_numpy``; inputs are made with numpy from a seed.
All configs are the reference's smoke reductions, in float32.

Tolerance: logits and hidden states within ``TOL`` of the largest
reference value, max |diff| <= TOL * max |want| (about 80 float32 ulps of
the largest logit; the two sum in different orders and XLA contracts
multiply-adds, measured at most 3.5e-7 of it across the families)."""
import _threads  # noqa: F401  (torch threads under xdist)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import sampling as j_sampling  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.layers import unembed as j_unembed  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import sampling as t_sampling  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.layers import unembed as t_unembed  # noqa: E402
from repro_torch.sharding import ctx as t_ctx  # noqa: E402

TOL = 1e-5
CPU = torch.device("cpu")

# one architecture per family; "encdec" is seamless with the text
# family's name (the reference treats encdec and audio alike)
FAMILIES = {
    "dense": ("phi4-mini-3.8b", {}),
    "moe": ("grok-1-314b", {}),
    "ssm": ("mamba2-130m", {}),
    "hybrid": ("hymba-1.5b", {}),
    "encdec": ("seamless-m4t-medium", {"family": "encdec"}),
    "vlm": ("pixtral-12b", {}),
    "audio": ("seamless-m4t-medium", {}),
}


def _cfgs(arch, **kw):
    j = j_configs.get_config(arch, smoke=True)
    t = t_configs.get_config(arch, smoke=True)
    if kw:
        j, t = j.replace(**kw), t.replace(**kw)
    return j, t


def _models(arch, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    params = jt.init_model(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, lm_params_from_numpy(tree, tcfg, device=CPU)


def _close(got, want, tol=TOL):
    got = (got.detach().float().numpy() if torch.is_tensor(got)
           else np.asarray(got))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    lim = tol * max(1.0, float(np.max(np.abs(want))))
    assert err <= lim, (err, lim)
    return err


_j_decode = jax.jit(jt.decode_step, static_argnums=(1,))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    for smoke in (False, True):
        j = j_configs.get_config(arch, smoke=smoke)
        t = t_configs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for active in (False, True):
            assert t.param_count(active) == j.param_count(active)
        assert (t.d_inner, t.n_ssm_heads, t.expert_ff) == (
            j.d_inner, j.n_ssm_heads, j.expert_ff)
        for js, ts in zip(j_configs.SHAPES, t_configs.SHAPES):
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
            assert t_configs.cell_runnable(t, ts) == \
                j_configs.cell_runnable(j, js)
            assert t_configs.shape_by_name(ts.name) == ts


@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_init_model_has_the_reference_tree(arch):
    """Random init makes every parameter of the reference's tree (names,
    shapes, dtypes), at its scales, the same from the same generator
    state, and carries the layer windows over."""
    jcfg, tcfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0), jcfg))
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    m1 = tt.init_model(tcfg, torch.Generator().manual_seed(3), device=CPU)
    m2 = tt.init_model(tcfg, torch.Generator().manual_seed(3), device=CPU)
    n_port = sum(p.numel() for p in m1.parameters())
    assert n_port == sum(int(np.prod(v.shape)) for v in flat.values())
    for (name, p), p2 in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, p2), name
        assert torch.isfinite(p.float()).all(), name
        assert str(p.dtype).split(".")[-1] == jcfg.param_dtype, name
    # the embedding is N(0, 1), as the reference's
    assert abs(float(m1.embed.tok.float().std()) - 1.0) < 0.05
    assert tt.layer_windows(tcfg) == np.asarray(
        jt.layer_windows(jcfg)).tolist()


def test_init_model_defaults_to_the_card():
    """No ``device``: the model goes to ``cuda``; without a card the call
    raises, it never builds it on the CPU."""
    _, tcfg = _cfgs("phi4-mini-3.8b")
    if torch.cuda.is_available():
        assert tt.init_model(tcfg).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tt.init_model(tcfg)
        with pytest.raises((AssertionError, RuntimeError)):
            tt.init_cache(tcfg, 1, 4)


def test_converter_refuses_a_tree_that_does_not_fit():
    jcfg, tcfg = _cfgs("phi4-mini-3.8b")
    tree = jax.tree.map(np.asarray, jt.init_model(jax.random.PRNGKey(0), jcfg))
    bad = dict(tree, embed={"tok": tree["embed"]["tok"][:, :7]})
    with pytest.raises(ValueError, match="embed.tok"):
        lm_params_from_numpy(bad, tcfg, device=CPU)
    missing = dict(tree, final_norm={})
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(missing, tcfg, device=CPU)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _decode_both(arch, b=2, steps=4, max_len=8, **kw):
    """Logits of ``steps`` decode steps through both packages, on tokens
    and source embeddings from a numpy seed; returns the pairs."""
    jcfg, tcfg, params, model = _models(arch, **kw)
    r = np.random.default_rng(1)
    toks = r.integers(0, jcfg.vocab, (b, steps)).astype(np.int32)
    jc = jt.init_cache(jcfg, b, max_len)
    tc = tt.init_cache(tcfg, b, max_len, device=CPU)
    if jcfg.family in ("encdec", "audio"):
        src = r.standard_normal((b, jcfg.enc_seq_len, jcfg.d_model),
                                dtype=np.float32)
        eo = jt.encode(params, jcfg, jnp.asarray(src), 8)
        teo = tt.encode(model, torch.from_numpy(src), 8)
        _close(teo, eo)
        jc = jt.prefill_cross_cache(params, jcfg, eo, jc)
        tc = tt.prefill_cross_cache(model, teo, tc)
    out = []
    for t in range(steps):
        jl, jc = _j_decode(params, jcfg, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t), jc)
        tl, tc = tt.decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                t, tc)
        out.append((tl, jl))
    return out, (tc, jc)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_logits_match_reference(family):
    arch, kw = FAMILIES[family]
    pairs, (tc, jc) = _decode_both(arch, **kw)
    for tl, jl in pairs:
        assert tl.shape == (2, t_configs.get_config(arch, True).vocab)
        _close(tl, jl)
    # the in-place cache holds what the reference's returned cache holds
    for name, want in jc.items():
        _close(tc[name], np.asarray(want, np.float32))


def test_int8_cache_decode_matches_reference():
    """qwen1.5-32b's adopted int8 KV cache (with QKV bias): the same int8
    payload and bf16 scales as the reference, and the same logits."""
    jcfg, _ = _cfgs("qwen1.5-32b")
    assert jcfg.cache_dtype == "int8" and jcfg.attn_bias
    pairs, (tc, jc) = _decode_both("qwen1.5-32b")
    for tl, jl in pairs:
        _close(tl, jl)
    for name in ("k", "v"):
        assert tc[name].dtype == torch.int8
        diff = np.abs(tc[name].numpy().astype(np.int32)
                      - np.asarray(jc[name]).astype(np.int32))
        # a payload may round the other way on a last-ulp scale difference
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for name in ("k_scale", "v_scale"):
        assert tc[name].dtype == torch.bfloat16
        _close(tc[name], np.asarray(jc[name], np.float32))


def test_sliding_window_decode_past_the_window_matches_reference():
    """hymba's windowed layers once the cache is longer than the window
    (smoke window 8, 12 steps)."""
    pairs, _ = _decode_both("hymba-1.5b", b=1, steps=12, max_len=12)
    for tl, jl in pairs:
        _close(tl, jl)


# --------------------------------------------------------------------------
# forward (train / prefill) and its parts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "encdec", "hybrid"])
def test_forward_matches_reference(family):
    """Hidden states and logits of a 16-token forward with q_block 8 (two
    query blocks; hybrid also two SSD chunks and a sliding window)."""
    arch, kw = FAMILIES[family]
    if family == "hybrid":
        kw = dict(kw, ssm_chunk=8)
    jcfg, tcfg, params, model = _models(arch, **kw)
    r = np.random.default_rng(2)
    toks = r.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    j_eo = t_eo = None
    if jcfg.family in ("encdec", "audio"):
        src = r.standard_normal((2, jcfg.enc_seq_len, jcfg.d_model),
                                dtype=np.float32)
        j_eo = jt.encode(params, jcfg, jnp.asarray(src), 8)
        t_eo = tt.encode(model, torch.from_numpy(src), 8)
    jh = jt.forward(params, jcfg, jnp.asarray(toks), enc_out=j_eo, q_block=8)
    th = tt.forward(model, torch.from_numpy(toks), enc_out=t_eo, q_block=8)
    _close(th, jh)
    _close(t_unembed(model.embed, tcfg, th),
           j_unembed(params["embed"], jcfg, jh))


def test_forward_vlm_frontend_matches_reference():
    jcfg, tcfg, params, model = _models("pixtral-12b")
    r = np.random.default_rng(3)
    toks = r.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    fr = r.standard_normal((2, jcfg.frontend_tokens, jcfg.d_model),
                           dtype=np.float32)
    jh = jt.forward(params, jcfg, jnp.asarray(toks), frontend=jnp.asarray(fr),
                    q_block=8)
    th = tt.forward(model, torch.from_numpy(toks), frontend=torch.from_numpy(fr),
                    q_block=8)
    _close(th, jh)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 6)])
def test_attend_blockwise_across_blocks_matches_reference(causal, window):
    """Several query and key blocks (online softmax carried across key
    blocks, fully masked blocks included), GQA 4 heads on 2."""
    r = np.random.default_rng(4)
    q = r.standard_normal((2, 16, 4, 8), dtype=np.float32)
    k = r.standard_normal((2, 16, 2, 8), dtype=np.float32)
    v = r.standard_normal((2, 16, 2, 8), dtype=np.float32)
    want = j_attn.attend_blockwise(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, q_block=4, kv_block=4)
    got = t_attn.attend_blockwise(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window, q_block=4, kv_block=4)
    _close(got, want)


def test_moe_dispatch_matches_reference():
    """Switch capacity dispatch with drops (capacity factor 1, top-2):
    outputs and aux losses; tied router scores keep the lower expert."""
    base = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
                n_kv=1, d_head=16, d_ff=64, vocab=64, n_experts=4, top_k=2,
                moe_d_ff=64, capacity_factor=1.0, dtype="float32")
    jcfg = j_configs.ModelConfig(**base)
    tcfg = t_configs.ModelConfig(**base)
    p = j_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    mod = t_moe.MoE(tcfg, CPU)
    with torch.no_grad():          # parameters take gradients
        for name, leaf in p.items():
            getattr(mod, name).copy_(torch.from_numpy(np.array(leaf)))
    x = np.random.default_rng(5).standard_normal((2, 32, 32), dtype=np.float32)
    jy, jaux = j_moe.apply_moe(p, jcfg, jnp.asarray(x))
    ty, taux = t_moe.apply_moe(mod, tcfg, torch.from_numpy(x))
    _close(ty, jy)
    for name in ("load_balance", "router_z", "drop_frac"):
        _close(taux[name].reshape(()), jaux[name])
    assert 0.0 < float(taux["drop_frac"]) < 0.5
    ties = np.array([[0.25, 0.5, 0.25, 0.5], [1.0, 1.0, 1.0, 1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(ties), 3)
    tv, ti = t_moe._top_k(torch.from_numpy(ties), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_activation_sharding_context_is_identity_or_refuses():
    x = torch.ones(2, 3)
    assert t_ctx.constrain(x, "residual") is x
    with t_ctx.activation_specs({"residual": None}):
        assert t_ctx.constrain(x, "residual") is x
    with t_ctx.activation_specs({"attn_q": ("batch", None, "model")}):
        assert t_ctx.constrain(x, "residual") is x
        with pytest.raises(NotImplementedError, match="no cell of repro_torch"):
            t_ctx.constrain(x, "attn_q")


# --------------------------------------------------------------------------
# generate
# --------------------------------------------------------------------------

def test_generate_greedy_tokens_equal_reference():
    """phi4-mini smoke, batch 2, prompt 6, 10 new tokens: the same tokens.
    Each step's top-2 logit margin must exceed twice the logit tolerance,
    so that a near-tie fails here rather than passing by luck."""
    jcfg, tcfg, params, model = _models("phi4-mini-3.8b", seed=4)
    prompt = np.random.default_rng(6).integers(
        0, jcfg.vocab, (2, 6)).astype(np.int32)
    want, jbits = j_sampling.generate(
        params, jcfg, jnp.asarray(prompt), jax.random.PRNGKey(2),
        max_new=10, sampler="greedy", q_block=6)
    got, bits = t_sampling.generate(
        model, torch.from_numpy(prompt), t_rng.PRNGKey(2), max_new=10,
        sampler="greedy", q_block=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and bits == int(jbits) == 0
    # replay the port's steps with the tokens fed back: margins
    cache = tt.init_cache(tcfg, 2, 16, device=CPU)
    cache, logits = t_sampling.prefill(model, torch.from_numpy(prompt), cache)
    for i in range(10):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin > 2 * TOL * float(logits.abs().max()), (i, margin)
        assert torch.equal(torch.argmax(logits, -1).to(torch.int32),
                           got[:, i])
        logits, cache = tt.decode_step(model, got[:, i:i + 1], 6 + i, cache)


@pytest.mark.parametrize("sampler", ["ky", "categorical"])
def test_generate_samplers_follow_the_reference_key_schedule(sampler):
    """At a temperature where the untrained model's steps are far from
    one-hot, KY and categorical generation give the reference's tokens
    and bits (phi4-mini smoke, 6 tokens): the same split per step, the
    same stage keys."""
    jcfg, tcfg, params, model = _models("phi4-mini-3.8b", seed=5)
    prompt = np.random.default_rng(7).integers(
        0, jcfg.vocab, (2, 4)).astype(np.int32)
    want, jbits = j_sampling.generate(
        params, jcfg, jnp.asarray(prompt), jax.random.PRNGKey(3),
        max_new=6, sampler=sampler, temperature=16.0, q_block=4)
    got, bits = t_sampling.generate(
        model, torch.from_numpy(prompt), t_rng.PRNGKey(3), max_new=6,
        sampler=sampler, temperature=16.0, q_block=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bits == int(jbits)
    if sampler == "ky":
        assert bits > 6 * 2 * 4  # not the deterministic bypass


def test_serve_step_fn_is_one_decode_step_and_sample():
    jcfg, tcfg, params, model = _models("mamba2-130m")
    cache = tt.init_cache(tcfg, 2, 4, device=CPU)
    tok = torch.tensor([[3], [9]], dtype=torch.int32)
    step = t_sampling.serve_step_fn(model, sampler="greedy")
    got, cache = step(t_rng.PRNGKey(0), tok, 0, cache)
    jstep = j_sampling.serve_step_fn(params, jcfg, sampler="greedy")
    want, _ = jstep(jax.random.PRNGKey(0), jnp.asarray(tok.numpy()),
                    jnp.int32(0), jt.init_cache(jcfg, 2, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_launcher_arch_runs_on_the_cpu_and_needs_a_card_by_default(
        capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "sampler=ky: 6 tokens" in out and "bits/token" in out
    assert "sample tokens[0]:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(["--arch", "mamba2-130m", "--smoke"])


# --------------------------------------------------------------------------
# training: loss_fn, gradients, remat
# --------------------------------------------------------------------------

# loss within LOSS_RTOL relative; each gradient leaf, re-stacked, within
# GRAD_TOL of that leaf's largest |g| (XLA's jit reorders sums and
# contracts multiply-adds, ROADMAP Queue 3).  A bfloat16 leaf (grok and
# nemotron keep bf16 parameters) is the float32 cotangent rounded to
# bf16, so an element whose two float32 values straddle a bf16 rounding
# boundary differs by one bf16 step: those leaves are held within
# GRAD_TOL of the largest |g| plus one bf16 step of the element (at most
# 2**-7 of its magnitude).
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_STEP = 2.0 ** -7


def _train_batch(jcfg, b=2, s=16, seed=3):
    """numpy tokens/labels (and frontend or source embeddings) from the
    reference's ``make_batch``."""
    from repro.configs.base import ShapeCfg
    from repro.training.data import make_batch

    return make_batch(jcfg, ShapeCfg("t", s, b, "train"), seed)


def _t_batch(batch, device=CPU):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


_j_loss_grad = jax.jit(jax.value_and_grad(jt.loss_fn), static_argnums=(1, 3))


def _port_loss_grads(model, batch, q_block):
    from repro_torch.models.transformer import param_leaves

    for p in model.parameters():
        p.grad = None
    loss = tt.loss_fn(model, _t_batch(batch), q_block)
    loss.backward()
    loss = loss.detach()
    grads = {k: (torch.stack([x.grad for x in p]) if isinstance(p, list)
                 else p.grad).float().numpy()
             for k, p in param_leaves(model).items()}
    return float(loss), grads


def _flat_tree(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(
        leaf, np.float32) if np.asarray(leaf).dtype.name == "bfloat16"
        else np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads_close(got: dict, want_tree, dtypes: dict):
    want = _flat_tree(want_tree)
    assert list(got) == list(want)        # the reference's leaf order
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        lim = GRAD_TOL * max(float(np.max(np.abs(w))), 1e-30)
        if dtypes[key] == torch.bfloat16:
            lim = lim + BF16_STEP * np.abs(w)
        err = np.abs(g - w)
        assert np.all(err <= lim), (key, float(err.max()), np.max(lim))
        worst = max(worst, float(err.max()) / max(float(np.abs(w).max()),
                                                  1e-30))
    return worst


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_gradients_match_reference(family):
    """``loss_fn`` and every gradient leaf for each family at smoke size
    (16 tokens, q_block 8: two query blocks; the moe family's aux loss,
    the vlm frontend and the encoder-decoder's source embeddings
    included), with the config's own remat ("full")."""
    from repro_torch.models.transformer import param_leaves

    arch, kw = FAMILIES[family]
    jcfg, tcfg, params, model = _models(arch, **kw)
    assert tcfg.remat == "full"
    batch = _train_batch(jcfg)
    jloss, jgrads = _j_loss_grad(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, 8)
    loss, grads = _port_loss_grads(model, batch, 8)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    dtypes = {k: (p[0] if isinstance(p, list) else p).dtype
              for k, p in param_leaves(model).items()}
    _grads_close(grads, jgrads, dtypes)
    if family == "moe":         # the aux loss is in the loss
        x, aux = tt.forward(model, _t_batch(batch)["tokens"], q_block=8,
                            return_aux=True)
        assert float(aux.detach()) > 0


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_remat_policies_give_the_full_remat_gradients(remat):
    """``dots`` (matrix products saved) and ``none`` recompute nothing
    differently: loss and gradients equal ``full``'s bit for bit (hybrid:
    attention, SSD and MLP in one layer)."""
    arch, kw = FAMILIES["hybrid"]
    _, tcfg, params, model = _models(arch, **kw)
    batch = _train_batch(j_configs.get_config(arch, smoke=True))
    want = _port_loss_grads(model, batch, 8)
    model.cfg = tcfg.replace(remat=remat)
    got = _port_loss_grads(model, batch, 8)
    assert got[0] == want[0]
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)


def test_chunked_xent_with_a_mask_over_chunks_matches_reference():
    """Several chunks (S 12, chunk 4), a 0/1 mask, softcapped logits:
    loss and the gradients to the hidden states and the head."""
    from repro.models.layers import chunked_xent as j_xent
    from repro_torch.models.layers import chunked_xent as t_xent

    jcfg, tcfg, params, model = _models("grok-1-314b")     # softcap 30
    assert tcfg.logit_softcap > 0
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 12, jcfg.d_model), dtype=np.float32)
    lab = r.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    mask = (r.random((2, 12)) < 0.7).astype(np.float32)

    def jf(x, emb):
        return j_xent(x, emb, jcfg, jnp.asarray(lab), jnp.asarray(mask),
                      chunk=4)

    jl, (jgx, jge) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), params["embed"])
    tx = torch.from_numpy(x).requires_grad_()
    tl = t_xent(tx, model.embed, tcfg, torch.from_numpy(lab),
                torch.from_numpy(mask), chunk=4)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _close(tx.grad, jgx, GRAD_TOL)
    assert model.embed.tok.grad is None          # not tied: no gradient
    want = np.asarray(jge["head"], np.float32)  # bf16 parameters
    lim = GRAD_TOL * np.abs(want).max() + BF16_STEP * np.abs(want)
    assert np.all(np.abs(model.embed.head.grad.float().numpy() - want) <= lim)
