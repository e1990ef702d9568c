"""The port's dry run (``repro_torch.launch.dryrun``) and hill-climb on the
CPU.

The dry run traces one layer, one microbatch, one loss chunk and one
attention block pair of a cell on a mesh of ``meta`` devices and scales
them; here its figures are held against what the whole step does on a
2 x 2 mesh of ``cpu`` devices at smoke width (dense phi4 and granite:
a cache split on kv heads and one split on the sequence; grok-1's
experts over "model"; hymba's attention, SSM projections and SSM state
over "model"): the bytes and
copies between mesh positions equal ``partition.TRAFFIC``'s exactly,
every position's argument bytes equal its placed shards', a decode cell
traces without reading a value, and refused cells keep the reference's
reason.
The reference's ``dryrun``/``hillclimb`` set a 512-device XLA flag at
import, so its hill-climb table is read from source, not imported."""
import _threads  # noqa: F401  (torch threads under xdist)
import ast
import copy
import json
import os
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.launch import builders, dryrun, hillclimb  # noqa: E402
from repro_torch.launch.mesh import make_lm_mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.sharding import ctx as t_ctx  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402
from repro_torch.training.data import make_batch  # noqa: E402

CPU = torch.device("cpu")
META = torch.device("meta")
# S 1024: two loss chunks; microbatch 2: two microbatches a step
SHAPES = {"train": ShapeCfg("t", 1024, 8, "train"),
          "prefill": ShapeCfg("p", 64, 4, "prefill"),
          "decode": ShapeCfg("d", 64, 4, "decode")}


def _cfg(arch):
    return t_configs.get_config(arch, smoke=True).replace(microbatch=2)


@pytest.fixture(scope="module")
def traced_cell():
    """``get(arch, kind)``: ``build_cell``'s cell of ``arch``'s smoke
    config at ``SHAPES[kind]``, traced on a 2 x 2 mesh of ``meta`` devices
    once for the module; the tests that hold the same cell read one
    record (none changes it)."""
    memo = {}

    def get(arch, kind):
        if (arch, kind) not in memo:
            memo[arch, kind] = dryrun.trace_cell(
                _cfg(arch), make_lm_mesh(2, 2, devices=[META] * 4),
                SHAPES[kind])
        return memo[arch, kind]

    return get


def _placed_bytes(tree) -> Counter:
    """Bytes each mesh position holds of a placed tree's tensors."""
    out: Counter = Counter()
    if isinstance(tree, partition.Sharded):
        for c in tree.coords():
            t = tree.shards[c]
            out[tree.position(c)] += t.numel() * t.element_size()
    elif isinstance(tree, torch.Tensor):
        out[(0, 0)] += tree.numel() * tree.element_size()
    elif isinstance(tree, dict):
        for v in tree.values():
            out += _placed_bytes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out += _placed_bytes(v)
    elif isinstance(tree, tt.LM):
        out += _placed_bytes(list(tt.param_leaves(tree).values()))
    elif isinstance(tree, ts.TrainState):
        out += _placed_bytes([tree.model, tree.opt, tree.step])
    return out


def _whole_step(cfg, shape):
    """The builders' cell run once on a 2 x 2 ``cpu`` mesh: (TRAFFIC,
    the bytes each position holds of its arguments)."""
    mesh = make_lm_mesh(2, 2, devices=[CPU] * 4)
    fn, _, insh, _, _ = builders.build_cell(cfg, mesh, shape)
    model = tt.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    spec = lambda tree: {k: v.spec for k, v in tree.items()}  # noqa: E731
    if shape.kind == "train":
        st = ts.place_train_state(mesh, ts.init_train_state(cfg, model))
        held = _placed_bytes(st)
        b = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, shape, 1).items()}
        partition.reset_traffic()
        fn(st, b)
        return dict(partition.TRAFFIC), held
    mdl = partition.place(mesh, model, spec(insh[0]))
    if shape.kind == "prefill":
        held = _placed_bytes(mdl)
        b = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, shape, 2).items() if k != "labels"}
        partition.reset_traffic()
        fn(mdl, b)
        return dict(partition.TRAFFIC), held
    cache = partition.place(
        mesh, tt.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device=CPU), spec(insh[4]))
    held = _placed_bytes([mdl, cache])
    tok = (torch.arange(shape.global_batch, dtype=torch.int32) * 7
           + 3)[:, None]
    # the dry run's decode: a Python position, up to the logits
    logits_fn = builders.build_decode(cfg, mesh, shape, sampler=None)[0]
    partition.reset_traffic()
    logits, _ = logits_fn(mdl, rng.PRNGKey(0), tok, shape.seq_len - 1,
                          cache)
    assert logits.shape == (shape.global_batch, cfg.vocab)
    return dict(partition.TRAFFIC), held


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "granite-20b",
                                  "grok-1-314b", "hymba-1.5b"])
def test_traced_cell_counts_what_the_whole_step_does(arch, kind,
                                                    traced_cell):
    """One traced layer (its activations for every batch shard) times
    the layers, one chunk times the chunks, one microbatch times the
    microbatches, plus the embedding, the head, the batch's split and
    the optimizer (Adafactor's statistics reckoned for the whole model
    from its layouts; AdamW copies nothing): exactly the whole
    step's bytes and copies; the kinds add up to the totals; each
    position's argument bytes, from the specs, equal its placed
    shards'."""
    cfg, shape = _cfg(arch), SHAPES[kind]
    want, held = _whole_step(cfg, shape)
    rec = traced_cell(arch, kind)
    assert rec["status"] == "ok", rec
    assert rec["traffic"]["crossed_bytes"] == want["crossed_bytes"] > 0
    assert rec["traffic"]["crossed_copies"] == want["crossed_copies"]
    coll = rec["collectives"]
    assert sum(v["bytes"] for v in coll.values()) == want["crossed_bytes"]
    assert sum(v["count"] for v in coll.values()) == want["crossed_copies"]
    assert set(coll) <= {"gather", "reduce-scatter", "broadcast",
                         "partial sum", "reshard", "input"}
    assert ("reduce-scatter" in coll) == (kind == "train")
    # the layer was traced once and scaled
    assert rec["scale"]["layers"] == cfg.n_layers
    assert "layer" in rec["segments"]
    mem = rec["memory"]
    assert mem["argument_bytes"] == max(held.values())
    assert mem["argument_bytes_sum"] == sum(held.values())
    assert mem["temp_bytes"] > 0 and mem["fits_80gb"]
    assert mem["total_per_device"] >= mem["argument_bytes"]


def test_trainer_step_is_traced_as_the_trainer_runs_it(traced_cell):
    """``trainer=True``: ``make_train_step``'s step (``launch/train.py``'s,
    and ``chip_smoke.py``'s ``lm_mesh``: no activation specs, the carry
    whole at home), exactly; fewer bytes than the builders' cell, whose
    carry is split over "model"."""
    _trainer_traced("phi4-mini-3.8b", traced_cell)


def test_hybrid_trainer_step_is_traced_as_the_trainer_runs_it(traced_cell):
    """The same for hymba smoke (``chip_smoke.py``'s
    ``lm_mesh_families``): its attention, MLP and SSM projections over
    "model"."""
    _trainer_traced("hymba-1.5b", traced_cell)


def _trainer_traced(arch, traced_cell):
    cfg, shape = _cfg(arch), SHAPES["train"]
    mesh = make_lm_mesh(2, 2, devices=[CPU] * 4)
    model = tt.place_model(mesh, tt.init_model(
        cfg, torch.Generator().manual_seed(0), device=CPU))
    state = ts.init_train_state(cfg, model)
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, shape, 1).items()}
    partition.reset_traffic()
    ts.make_train_step(cfg, mesh=mesh)[0](state, batch)
    want = {k: partition.TRAFFIC[k] for k in ("crossed_bytes",
                                              "crossed_copies")}
    meta = make_lm_mesh(2, 2, devices=[META] * 4)
    rec = dryrun.trace_cell(cfg, meta, shape, trainer=True)
    assert rec["traffic"] == want
    assert rec["memory"]["argument_bytes_sum"] == sum(
        _placed_bytes(state).values())
    cell = traced_cell(arch, "train")
    assert cell["traffic"]["crossed_bytes"] > rec["traffic"]["crossed_bytes"]


def test_decode_traces_without_reading_a_value():
    """The decode cell reaches its logits on ``meta`` (a host read of a
    ``meta`` tensor raises), and the builders' decode still takes a 0-d
    position tensor on real devices."""
    cfg = _cfg("phi4-mini-3.8b")
    rec = dryrun.trace_cell(cfg, make_lm_mesh(2, 2, devices=[META] * 4),
                            SHAPES["decode"])
    assert rec["status"] == "ok" and rec["t_trace_s"] < 30
    with pytest.raises(RuntimeError):
        int(torch.zeros((), dtype=torch.int32, device=META))
    mesh = make_lm_mesh(1, 1, devices=[CPU])
    fn, _, insh, _, _ = builders.build_decode(cfg, mesh, SHAPES["decode"],
                                              sampler=None)
    mdl = partition.place(mesh, tt.init_model(cfg, device=CPU),
                          {k: v.spec for k, v in insh[0].items()})
    cache = partition.place(mesh, tt.init_cache(cfg, 4, 64, device=CPU),
                            {k: v.spec for k, v in insh[4].items()})
    tok = torch.zeros((4, 1), dtype=torch.int32)
    a, _ = fn(mdl, rng.PRNGKey(0), tok, torch.tensor(3), copy.deepcopy(
        cache))
    b, _ = fn(mdl, rng.PRNGKey(0), tok, 3, cache)
    assert torch.equal(a, b)


def test_skips_name_the_reference_reason_and_the_roadmap_item(
        tmp_path, monkeypatch, traced_cell):
    """Cells ``cell_runnable`` refuses carry the reference's reason; a
    layout the port refuses is skipped with the refusal's own text, which
    says no cell of the port lays activations out so; the MoE, SSM and
    hybrid families trace on a "model" axis; the "dots" remat on a mesh traces, its
    transients above "full"'s by the saved matrix products, its bytes
    between positions the same."""
    for arch in t_configs.ARCH_IDS:
        for s in t_configs.SHAPES:
            ok, why = j_configs.cell_runnable(j_configs.get_config(arch),
                                              j_configs.shape_by_name(s.name))
            if not ok:
                rec = dryrun.run_cell(arch, s.name, multi_pod=False,
                                      out_dir=str(tmp_path))
                assert rec == {"arch": arch, "shape": s.name,
                               "mesh": "16x16", "status": "skipped",
                               "reason": why}
    mesh = make_lm_mesh(2, 2, devices=[META] * 4)
    spec = ("data", None, "model")
    with t_ctx.activation_specs({"residual": spec}):
        with pytest.raises(NotImplementedError) as refused:
            t_ctx.constrain(torch.zeros(2, 4, 8), "residual")
    why = str(refused.value)
    assert "no cell of repro_torch" in why and "'residual'" in why
    assert "ROADMAP" not in why

    def refusing(*args):
        raise t_ctx._refuse("residual", spec)

    monkeypatch.setattr(dryrun, "_trace", refusing)
    assert dryrun.trace_cell(_cfg("phi4-mini-3.8b"), mesh,
                             SHAPES["train"]) == {"status": "skipped",
                                                  "reason": why}
    monkeypatch.undo()
    for arch in ("grok-1-314b", "llama4-scout-17b-a16e", "mamba2-130m",
                 "hymba-1.5b"):
        rec = dryrun.trace_cell(t_configs.get_config(arch, smoke=True),
                                mesh, SHAPES["train"])
        assert rec["status"] == "ok", rec
        assert rec["collectives"]["reshard"]["bytes"] > 0
    full = traced_cell("phi4-mini-3.8b", "train")
    rec = dryrun.trace_cell(_cfg("phi4-mini-3.8b").replace(remat="dots"),
                            mesh, SHAPES["train"])
    assert rec["status"] == "ok", rec
    assert rec["memory"]["temp_bytes"] > full["memory"]["temp_bytes"]
    assert rec["traffic"] == full["traffic"]


def test_production_cell_and_the_command_line(tmp_path, monkeypatch,
                                              capsys):
    """A production cell on the 16 x 16 mesh of ``meta`` devices with
    its H100 roofline; the command line's flags and JSON layout."""
    rec = dryrun.run_cell("phi4-mini-3.8b", "decode_32k", multi_pod=False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["roofline"]["chips"] == 256
    assert rec["scale"]["batch_shards"] == 16
    assert rec["collectives"]["gather"]["bytes"] > 0
    with open(tmp_path / "phi4-mini-3.8b__decode_32k__16x16.json") as f:
        assert json.load(f)["traffic"] == rec["traffic"]
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "mamba2-130m", "--shape", "decode_32k",
        "--both-meshes", "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "done: 2 ok, 0 skipped, 0 errors" in out
    assert os.path.exists(tmp_path / "mamba2-130m__decode_32k__pod2x16x16"
                          ".json")


def test_hillclimb_cells_are_the_references():
    """The hill-climb's cells, variants and hypotheses, word for word
    (read from the reference's source: importing it would force 512
    host devices on this process's JAX)."""
    src = open(os.path.join(REPO, "src", "repro", "launch",
                            "hillclimb.py")).read()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "CELLS")
    assert hillclimb.CELLS == ast.literal_eval(node.value)


def test_hillclimb_traces_mb4_dots_and_a_refused_cell_keeps_its_reason(
        tmp_path):
    """Cell B's ``mb4_dots`` has a dry run beside its roofline; a cell
    ``cell_runnable`` refuses still records the reference's reason."""
    m = hillclimb.measure("qwen1.5-32b", "train_4k",
                          {"microbatch": 4, "remat": "dots"})
    assert m["dryrun_status"] == "ok"
    assert m["mem_per_chip_gb"] > 0 and m["crossed_bytes"] > 0
    assert 0 < m["roofline"]["roofline_fraction"] <= 1
    ok, why = t_configs.cell_runnable(t_configs.get_config("qwen1.5-32b"),
                                      t_configs.shape_by_name("long_500k"))
    assert not ok
    rec = dryrun.run_cell("qwen1.5-32b", "long_500k", multi_pod=False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "skipped" and rec["reason"] == why
