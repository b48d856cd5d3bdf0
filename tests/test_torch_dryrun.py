"""The dry run of the port (``repro_torch.launch.steps``' specs and cells,
``launch.opcensus``, ``launch.dryrun``) against the reference's
(``repro.launch.steps``, ``repro.launch.hloparse``).

The specs are compared at full width for every architecture, shape and
production mesh, with a stub mesh on both sides; the reference's trees
come from ``jax.eval_shape``, the port's from them by ``interop``'s path
mapping (a group's repeats split into one dict per layer), as meta
tensors.  Every fake process group lives inside a fixture that destroys
it, so no later test in the worker sees one.
"""
from __future__ import annotations

import dataclasses
import json
import math
from functools import partial

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import configs as RC
from repro.launch import hloparse as RH
from repro.launch import steps as RS
from repro.models import model as RM
from repro.optim import OptConfig as RefOptConfig
from repro.optim import init_opt_state as ref_init_opt_state
from repro_torch import configs as TC
from repro_torch._tree import flatten
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import opcensus as OC
from repro_torch.launch import steps as TS
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
KNOBS = dict(seq_shard_kv=True, serve_params_tp_only=True, seq_parallel=True)


def ref_mesh(sizes, names):
    class FakeMesh:  # the reference's rules read only shape and axis_names
        shape = dict(zip(names, sizes))
        axis_names = names
    return FakeMesh()


def entries(spec):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(spec)


def meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def port_layers(groups, blocks):
    """The reference's stacked groups (tuples of per-position trees whose
    leaves lead with ``repeats``) in the port's layer order: (the
    position's stacked tree, the repeat) per layer."""
    out = []
    for (pattern, reps), group in zip(blocks, groups):
        for r in range(reps):
            for i in range(len(pattern)):
                out.append((group[i], r))
    return out


def to_port(ptree, cfg, leaf=lambda x, r: x):
    """The reference's parameter-shaped tree in the port's layout: each
    stacked leaf through ``leaf(x, r)`` (``r`` its repeat; None for a leaf
    that stands alone)."""
    def split(groups, blocks):
        return [jax.tree.map(lambda x, r=r: leaf(x, r), g) for g, r in port_layers(groups, blocks)]

    out = {k: leaf(v, None) for k, v in ptree.items() if k not in ("groups", "enc")}
    out["layers"] = split(ptree["groups"], cfg.blocks)
    if "enc" in ptree:
        enc = ptree["enc"]
        enc_blocks = (((RM.LayerSpec(kind="attn", window=None, mlp="dense"),),
                       cfg.n_enc_layers),)
        out["enc"] = {"layers": split(enc["groups"], enc_blocks),
                      "final_norm": leaf(enc["final_norm"], None),
                      "pos_embed": leaf(enc["pos_embed"], None)}
    return out


def layer_shape(x, r):
    return meta(x.shape if r is None else x.shape[1:])


def spec_leaf(x, r):
    return entries(x) if r is None else entries(x)[1:]


def as_plain(tree):
    """A port spec tree with jax's containers as dicts and lists."""
    if isinstance(tree, dict):
        return {k: as_plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_plain(v) for v in tree]
    return tree


@pytest.fixture(scope="module")
def ref_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = RC.get_arch(arch).model
            cache[arch] = jax.eval_shape(partial(RM.init_params, cfg=cfg), jax.random.PRNGKey(0))
        return cache[arch]
    return get


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_specs_equal_the_reference(arch, mesh_name, ref_shapes):
    sizes, names = MESHES[mesh_name]
    rmesh, tmesh = ref_mesh(sizes, names), (sizes, names)
    for knobs in ({}, KNOBS):
        rcfg = dataclasses.replace(RC.get_arch(arch).model, **knobs)
        tcfg = dataclasses.replace(TC.get_arch(arch).model, **knobs)
        pshapes = ref_shapes(arch)
        rspecs = RS.param_specs(pshapes, rcfg, rmesh)
        tparams = to_port(pshapes, rcfg, layer_shape)
        tspecs = TS.param_specs(tparams, tcfg, tmesh)
        want = to_port(rspecs, rcfg, spec_leaf)
        assert tspecs == as_plain(want)
        assert TS.tp_only(tspecs) == as_plain(to_port(
            jax.tree.map(lambda s: P(*(a if a == "model" else None for a in s)), rspecs,
                         is_leaf=lambda x: isinstance(x, P)), rcfg, spec_leaf))
        for kind in ("adamw", "adafactor"):
            rstate = jax.eval_shape(
                lambda p: {"params": p, "opt": ref_init_opt_state(p, RefOptConfig(kind=kind))},
                pshapes)
            rss = RS.state_specs(rstate, rspecs)
            tstate = {"params": tparams,
                      "opt": init_opt_state(tparams, OptConfig(kind=kind), tcfg)}
            tss = TS.state_specs(tstate, tspecs, tcfg)
            assert tss["params"] == tspecs
            assert tss["opt"]["step"] == entries(rss["opt"]["step"]) == ()
            assert tss["opt"]["m"] == as_plain(to_port(rss["opt"]["m"], rcfg, spec_leaf))
            if kind == "adamw":
                assert tss["opt"]["v"] == as_plain(to_port(rss["opt"]["v"], rcfg, spec_leaf))
            else:   # per stacked leaf, under the reference's own tree path
                rv = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): s
                      for path, s in jax.tree_util.tree_flatten_with_path(
                          rss["opt"]["v"], is_leaf=lambda x: isinstance(x, P))[0]}
                tv = {f"{name}/{stat}": s for name, st in tss["opt"]["v"].items()
                      for stat, s in st.items()}
                assert tv == {k: entries(s) for k, s in rv.items()}
        for shape_name, (seq, batch, kind) in RC.get_arch(arch).shapes():
            assert TS.batch_specs(tcfg, tmesh, batch) == {
                k: entries(s) for k, s in RS.batch_specs(rcfg, rmesh, batch).items()}
            got = TS.batch_struct(tcfg, seq, batch)
            ref = RS.batch_struct(rcfg, seq, batch)
            assert {k: (v.shape, str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
                == {k: (v.shape, str(v.dtype)) for k, v in ref.items()}
            rcs = RS.cache_specs(rcfg, rmesh, batch)
            flat = [entries_tree(c) for g, (pattern, reps) in zip(rcs, rcfg.blocks)
                    for _ in range(reps) for c in g]
            assert TS.cache_specs(tcfg, tmesh, batch) == flat
            rpol = RS.activation_policy(rcfg, jax_mesh_stub(sizes, names), batch)
            tpol = TS.activation_policy(tcfg, tmesh, batch)
            assert tpol == {k: TS.placements(entries(v.spec), tmesh) for k, v in rpol.items()}


def entries_tree(c):
    """One layer of the reference's cache specs, less the stacked axis."""
    return {k: entries(s)[1:] for k, s in c.items()}


def jax_mesh_stub(sizes, names):
    """``activation_policy`` wraps its specs in ``NamedSharding``, which
    wants a real mesh: an abstract one of the production sizes."""
    return jax.sharding.AbstractMesh(tuple(sizes), tuple(names))


def test_placements_by_hand():
    mesh = ((2, 16, 16), ("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    assert TS.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert TS.placements((None, None), mesh) == (Replicate(),) * 3
    assert TS._fit(256, ("pod", "data"), mesh) == ("pod", "data")
    assert TS._fit(2, ("pod", "data"), mesh) == "pod"
    assert TS._fit(1, ("pod", "data"), mesh) is None


# ------------------------------------------------------------------ census
@pytest.fixture
def fake_world():
    """``start(n)`` starts a fake world of n ranks; it is destroyed after
    the test."""
    yield TM.start_fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


HLO_COLLECTIVES = """
HloModule coll

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main (p0: f32[64,32]) -> f32[64,32] {
  %p0 = f32[64,32] parameter(0)
  %ag = f32[256,32] all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[64,32] all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[16,32] reduce-scatter(%p0), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %a2a = f32[64,32] all-to-all(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  ROOT %cp = f32[64,32] collective-permute(%p0), source_target_pairs={{0,1},{1,2},{2,3},{3,0}}
}
"""


def test_census_wire_bytes_equal_hloparse(fake_world):
    """The same five collectives over 4 ranks: the census's ring-model
    bytes equal the reference's ``parse_hlo_costs`` on their HLO."""
    fake_world(4)
    want = RH.parse_hlo_costs(HLO_COLLECTIVES)["wire"]
    x = torch.zeros(64, 32)
    with OC.op_census() as c:
        dist.all_gather_into_tensor(torch.empty(256, 32), x)
        dist.all_reduce(x)
        dist.reduce_scatter_tensor(torch.empty(16, 32), x)
        dist.all_to_all_single(torch.empty(64, 32), x)
        dist.send(x, dst=1)
    got = c.result()["wire"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k]), k
    assert {k: c.result()["calls"][k] for k in want} == {k: 1 for k in want}


def test_fake_world_makes_cpu_meshes_only(fake_world):
    """The fake group moves no data: a ``cpu`` mesh (the dry run's) passes
    over it, a ``cuda`` one is refused before any rank could train on it."""
    fake_world(4)
    assert TM.make_mesh((2, 2), ("data", "model"), device="cpu").shape == (2, 2)
    with pytest.raises(ValueError, match="nccl"):
        TM._check_group("cuda")


def test_census_counts_by_hand():
    """bytes, FLOPs and the live peak of a small program, counted by hand."""
    a = torch.randn(4, 8)
    b = torch.randn(8, 16)
    with OC.op_census(a, b) as c:
        m = a @ b            # reads 32 + 128 floats, writes 64; 2·4·8·16 FLOPs
        r = m.relu()         # reads 64, writes 64
        v = r.t()            # a view: nothing
        s = v.sum()          # reads 64, writes 1
        del m                # freed before the next allocation
        e = torch.empty(10)  # allocates 40 bytes, moves none
    res = c.result()
    assert res["flops"] == 2 * 4 * 8 * 16
    assert res["by_op"] == {"aten.mm": (32 + 128 + 64) * 4, "aten.relu": 128 * 4,
                            "aten.sum": 65 * 4}
    assert res["hbm_bytes"] == (224 + 128 + 65) * 4
    held = (32 + 128) * 4
    assert res["peak"] == held + 256 + 256 + 4            # a, b, m, r and s
    assert c.live == held + 256 + 4 + 40                 # r, s and e; m is freed
    assert res["calls"]["aten.t"] == 1 and "aten.t" not in res["by_op"]
    del r, s, v, e


def test_census_counts_kernel_temporaries():
    """The temporaries a kernel allocates inside itself: ``logsumexp``'s
    whole ``exp``, softmax's copy of an operand that is not contiguous
    (none for a contiguous one), the softmax backward's product; each
    live while the op runs."""
    x = torch.randn(16, 8)
    xt = x.t()                                   # (8, 16), not contiguous
    with OC.op_census(x) as c:
        y = xt.softmax(-1)                       # copies xt: 512 bytes
    assert c.result()["peak"] == 512 + 512 + 512 and c.result()["by_op"]["aten._softmax"] == 4 * 512
    with OC.op_census(x, y) as c:
        z = y.softmax(-1)                        # y is contiguous: no copy
        w = torch.logsumexp(x, -1)               # exp(x - max): 512 bytes
    assert c.result()["peak"] == 3 * 512 + 64 + 512
    assert c.result()["by_op"]["aten._softmax"] == 2 * 512
    assert c.result()["by_op"]["aten.logsumexp"] == 512 + 64 + 2 * 512
    g = torch.randn(8, 16)
    with OC.op_census(y, g) as c:
        torch.ops.aten._softmax_backward_data(g, y, -1, torch.float32)   # its product: 512
        torch.ops.aten._softmax_backward_data(g.t().contiguous().t(), y, -1, torch.float32)
    # the second: y, g, its strided copy gt, the result, the product and
    # the kernel's contiguous copy of gt (the first's result is freed)
    assert c.result()["peak"] == 512 * 6
    del z, w


# ------------------------------------------------------------------ cells
def small(arch):
    spec = TC.get_arch(arch)
    return dataclasses.replace(spec, model=TC.shrink(spec.model))


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-v2-lite-16b", "train_4k"),     # MLA + MoE, EP over model
    ("whisper-base", "prefill_32k"),          # encoder-decoder caches
    ("jamba-v0.1-52b", "decode_32k"),         # Mamba + attention caches, the MoE
])
def test_build_and_run_cell(arch, shape, fake_world, tmp_path):
    """One shrink() cell of each kind over a 2 x 2 fake world: the
    arguments are fake tensors at one rank's share, the record's
    accounting holds together."""
    from torch._subclasses.fake_tensor import FakeTensor
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    spec = small(arch)
    seq, batch, kind = TC.SHAPES[shape]
    cell = TS.build_cell(spec, shape, mesh)
    assert cell.kind == kind and cell.model_cfg.param_dtype == "bfloat16"
    assert cell.model_cfg.remat == ("dots" if kind == "train" else "none")
    assert all(isinstance(t, FakeTensor) for t in flatten(list(cell.args)).values())
    assert cell.layout["batch_local"] == batch // 2
    tokens = cell.parts["batch"]["tokens"]
    assert tokens.shape[0] == batch // 2
    rec = TD.run_cell(arch, shape, multi_pod=False, out_dir=tmp_path, mesh=mesh, spec=spec)
    assert json.loads((tmp_path / f"{arch}__{shape}__single.json").read_text()) == \
        json.loads(json.dumps(rec))
    bpd = rec["bytes_per_device"]
    part = "state" if kind == "train" else "params"
    assert bpd["peak"] >= bpd[part] + bpd["batch"] + bpd["cache"] > 0
    assert bpd["peak"] == bpd[part] + bpd["batch"] + bpd["cache"] + bpd["activations_peak"]
    # the state (train) or the parameters (serving) are the rank's blocks:
    # exactly what the specs give
    assert 0 < bpd["state_under_specs"] == bpd[part]
    assert rec["flops"] > 0 and rec["bytes"] == pytest.approx(sum(rec["by_op"].values()))
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    if kind == "train":
        # the leaves' all-gathers and their gradients' reduce-scatters, the
        # mean over data of what is not cut over it, the EP exchanges
        assert set(rec["collectives"]) == {"all-gather", "reduce-scatter", "all-reduce",
                                           "all-to-all"}
        assert rec["optimizer"]["kind"] == "adamw"
    else:
        # the leaves' all-gathers over data, the tensor-parallel all-reduces
        # over model, the next token's all-gather over model
        assert {"all-gather", "all-reduce"} <= set(rec["collectives"])
        caches = cell.parts["cache"]
        assert all(t.shape[0] == batch // 2 for c in caches for t in c.values())
        assert bpd["cache_under_specs"] == bpd["cache"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cell_holds_blocks_and_counts_tp_all_reduces(kind, fake_world):
    """A shrink(stablelm) serving cell over a 2 x 2 fake world holds the
    rank's blocks of the parameters, exactly ``bytes_under_specs``, and
    the rank's KV heads in its caches; its census counts the tensor-parallel
    all-reduces: one after the vocab-parallel lookup and one after each
    layer's attention and MLP, each of the rank's (B, S, D) hidden states
    (ring model over a group of 2: the tensor's bytes on the wire), and
    the next token's all-gather over ``model``."""
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    seq, batch = 64, 4
    cell = TS.build_cell(small("stablelm-1.6b"), f"{kind}_32k", mesh, shape=(seq, batch, kind))
    cfg = cell.model_cfg
    with cell.mode:
        held = OC.Census().hold(cell.parts["params"])
        assert held == TS.bytes_under_specs(cell.whole, cell.specs, mesh) > 0
        assert held < OC.Census().hold(cell.whole) // 2
        with OC.op_census(*cell.args) as c:
            cell.fn(*cell.args)
    k = cell.parts["cache"][0]["k"]
    assert tuple(k.shape) == (batch // 2, seq, cfg.n_kv_heads // 2, cfg.head_dim)
    res = c.result()
    tokens = batch // 2 * (seq if kind == "prefill" else 1)
    hidden = tokens * cfg.d_model * 2                                 # bf16
    assert res["calls"]["all-reduce"] == 2 * cfg.n_layers + 1
    assert res["wire"]["all-reduce"] == (2 * cfg.n_layers + 1) * hidden
    assert res["calls"]["all-gather"] >= 1


class ReduceScatters(torch.utils._python_dispatch.TorchDispatchMode):
    """The input shape and group size of every reduce-scatter."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if OC.COLLECTIVES.get(func._schema.name, ("",))[0] == "reduce-scatter":
            self.seen.append((tuple(args[1].shape) if isinstance(args[1], torch.Tensor)
                              else tuple(args[1][0].shape), OC._group_size(args)))
        return func(*args, **(kwargs or {}))


def test_census_counts_in_proj_reduce_scatter_over_model(fake_world):
    """A shrink(jamba) train cell over a 2 x 2 fake world: each Mamba
    layer's ``in_proj`` gradient, gathered over ``model`` where its layer
    runs, is reduce-scattered (summed) back over it, (2·d_inner, D/2)
    after the one over ``data``, and the census's reduce-scatter wire
    bytes hold those sums' ring cost."""
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    cell = TS.build_cell(small("jamba-v0.1-52b"), "train_4k", mesh, shape=(16, 8, "train"))
    cfg = cell.model_cfg
    n_mamba = sum(s.kind == "mamba" for p, r in cfg.blocks for s in p for _ in range(r))
    with cell.mode:
        with OC.op_census(*cell.args) as c, ReduceScatters() as rs:
            cell.fn(*cell.args)
    in_proj = (2 * cfg.d_inner, cfg.d_model // 2)
    assert rs.seen.count((in_proj, 2)) == n_mamba > 0
    ring = n_mamba * math.prod(in_proj) * 2 * (2 - 1) / 2      # bf16, a group of 2
    assert c.result()["wire"]["reduce-scatter"] >= ring


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_train_state_equals_state_under_specs(arch, multi_pod, fake_world):
    """At full width over each production mesh, a train cell's state is
    the rank's blocks: its bytes (the census's count of the storages it
    holds) equal the whole state's under the reference's specs."""
    fake_world(512 if multi_pod else 256)
    mesh = TM.make_production_mesh(multi_pod=multi_pod)
    shape = next(s for s, (_, _, kind) in TC.get_arch(arch).shapes() if kind == "train")
    cell = TS.build_cell(TC.get_arch(arch), shape, mesh)
    with cell.mode:
        held = OC.Census().hold(cell.parts["state"])
        under = TS.bytes_under_specs(cell.whole, cell.specs, mesh)
    assert cell.layout["params"].startswith("the rank's block")
    assert held == under > 0


def test_sa_cell_counts_launches_times_the_cost_model(fake_world, tmp_path):
    from repro_torch.core import SAConfig
    from repro_torch.kernels import bounds as B
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    rec = TD.run_sa_cell(multi_pod=False, out_dir=tmp_path, mesh=mesh, n_chains=1 << 12, dim=64,
                         n_steps=10)
    L = SAConfig(T0=1000.0, T_min=0.01, rho=0.99, N=10).n_levels
    assert rec["levels"] == L == 1146
    assert rec["launches"] == {"b1": L, "b2": 2 * L, "all-gather": L}
    n = (1 << 12) // 4
    b1_bytes, b1_s = B.b1_cost(n, 64, 10)["full"]
    assert rec["bytes"] == L * (b1_bytes + 2 * n * 4)
    assert rec["roofline"]["compute_s"] == pytest.approx(L * b1_s)
    assert rec["collectives"]["all-gather"] == pytest.approx(L * 4 * 65 * 4 * 3 / 4)
    assert (tmp_path / "sa_schwefel64__sync__single.json").exists()


def test_main_writes_a_record_per_cell(tmp_path, monkeypatch):
    """``main`` over the production mesh, with shrink() models: one record
    per job; its jobs are the reference's."""
    monkeypatch.setattr(TD, "get_arch", lambda a: small(a))
    recs = TD.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--both-meshes", "--sa",
                    "--out", str(tmp_path)])
    assert not dist.is_initialized()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "sa_schwefel512__sync__multi.json", "sa_schwefel512__sync__single.json",
        "stablelm-1.6b__decode_32k__multi.json", "stablelm-1.6b__decode_32k__single.json"]
    assert [r["n_chips"] for r in recs] == [256, 256, 512, 512]
    monkeypatch.undo()
    import argparse
    args = argparse.Namespace(all=True, sa=True, both_meshes=True, multi_pod=False, arch=None,
                              shape=None)
    jobs = TD.jobs_of(args)
    want = [("sa", None, mp) for mp in (False, True)] + [
        (a, s, mp) for a in RC.ARCH_IDS for s, _ in RC.get_arch(a).shapes() for mp in (False, True)]
    assert jobs == want


def test_adafactor_state_under_specs(fake_world):
    """Adafactor's second moments, kept per stacked leaf under the
    reference's tree path, are laid out by their stacked specs: the
    cell's blocks of them hold what the specs give of the whole."""
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    cell = TS.build_cell(small("deepseek-v2-lite-16b"), "train_4k", mesh,
                         ocfg=OptConfig(kind="adafactor"))
    with cell.mode:
        def nbytes(tree):
            return sum(t.numel() * t.element_size() for t in flatten(tree).values())
        state, whole = cell.parts["state"], cell.whole
        under = TS.bytes_under_specs(whole, cell.specs, mesh)
        v_under = TS.bytes_under_specs(whole["opt"]["v"], cell.specs["opt"]["v"], mesh)
    assert 0 < under == nbytes(state) < nbytes(whole)
    assert 0 < v_under == nbytes(state["opt"]["v"]) < nbytes(whole["opt"]["v"])


class AllGathers(torch.utils._python_dispatch.TorchDispatchMode):
    """The output shape of every all-gather."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if OC.COLLECTIVES.get(func._schema.name, ("",))[0] == "all-gather":
            self.seen.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def serving_census(arch, seq, batch, mesh, **over):
    """A shrink() decode cell of ``seq`` positions and global ``batch``:
    its cell, census result, all-gathers and the bytes of its caches."""
    cell = TS.build_cell(small(arch), "decode_32k", mesh, overrides=over,
                         shape=(seq, batch, "decode"))
    with cell.mode:
        held = OC.Census().hold(cell.parts["cache"])
        with OC.op_census(*cell.args) as c, AllGathers() as ag:
            cell.fn(*cell.args)
    return cell, c.result(), ag.seen, held


@pytest.mark.parametrize("arch,cut_batch,knob", [
    ("gemma3-4b", 1, False),            # batch 1: every layer cut over 'data'
    ("granite-20b", 2, True),           # seq_shard_kv: one KV head, cut over 'model'
    ("deepseek-v2-lite-16b", 2, True),  # seq_shard_kv: MLA's latent cache over 'model'
])
def test_seq_cut_cell_holds_cache_under_specs_and_counts_the_combine(arch, cut_batch, knob,
                                                                     fake_world):
    """A shrink() decode cell over a 2 x 2 fake world whose caches are cut
    on the sequence holds its block of the cache, exactly
    ``bytes_under_specs`` of the whole cache under ``cache_specs``; its
    census counts, beside the same cell uncut (batch 2, no knob: the
    rank's rows and heads alike), two more all-reduces per cut layer (the
    combine's MAX of m and SUM of l and o), their bytes on the wire (ring
    over 2 ranks: the operand's bytes), and under ``seq_shard_kv`` with
    the q heads cut one all-gather of the q heads per layer."""
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    seq = 64
    cell, res, gathers, held = serving_census(arch, seq, cut_batch, mesh, seq_shard_kv=knob)
    _, base, base_gathers, _ = serving_census(arch, seq, 2, mesh)
    cfg = cell.model_cfg
    assert held == TS.bytes_under_specs(cell.whole_cache, cell.cache_specs, mesh) > 0
    plan, _ = TS._serving_plan(cfg, mesh, cell.specs, cut_batch, seq)
    cuts = [c for c in plan.seq if c is not None]
    assert cuts and all(c.axes == (("model",) if knob else ("data",)) for c in cuts)
    gathered = knob and cfg.n_heads % 2 == 0          # the q heads cut over 'model'
    heads = cfg.n_heads if knob else cfg.n_heads // 2
    width = cfg.kv_lora or cfg.head_dim
    assert res["calls"]["all-reduce"] - base["calls"]["all-reduce"] == 2 * len(cuts)
    merge = len(cuts) * heads * (1 + 1 + width) * 4      # m, then l and o, float32
    assert res["wire"]["all-reduce"] - base["wire"]["all-reduce"] == merge
    extra = [g for g in gathers if g not in base_gathers or gathers.count(g) > base_gathers.count(g)]
    if gathered:
        q = (2, 1, cfg.n_heads // 2, (cfg.kv_lora + cfg.d_rope) or cfg.head_dim)
        assert len(gathers) - len(base_gathers) == len(cuts) and set(extra) == {q}
        assert res["wire"]["all-gather"] - base["wire"]["all-gather"] == \
            len(cuts) * math.prod(q) * 2 / 2                 # bf16, half of it from the peer
    else:
        assert len(gathers) == len(base_gathers)
    for layer, spec, c in zip(cell.parts["cache"], M.layer_specs(cfg), plan.seq):
        if c is not None:
            slots = (layer.get("k") if "k" in layer else layer["c_kv"]).shape[1]
            assert slots == M.cache_length(spec, seq) // 2


@pytest.mark.parametrize("arch,cut_batch,knob", [
    ("gemma3-4b", 1, False),            # batch 1: the caches cut over 'data'
    ("granite-20b", 2, True),           # seq_shard_kv: cut over 'model'
])
def test_serving_steps_refuse_caches_of_another_layout(arch, cut_batch, knob, fake_world):
    """Over a 2 x 2 fake world the serving steps with specs need the
    global batch and ``s_max``, and refuse caches whose slots are not the
    ones those give the rank: the whole sequence where it is cut, a
    block of it where it is not, or another ``s_max``'s."""
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    seq = 64
    cell = TS.build_cell(small(arch), "decode_32k", mesh, overrides={"seq_shard_kv": knob},
                         shape=(seq, cut_batch, "decode"))
    cfg = cell.model_cfg
    with pytest.raises(ValueError, match="batch and s_max"):
        TS.make_serve_step(cfg, mesh, cell.specs)
    with pytest.raises(ValueError, match="batch and s_max"):
        TS.make_prefill_step(cfg, mesh, cell.specs, batch=cut_batch)
    uncut = dataclasses.replace(cfg, seq_shard_kv=False)      # at batch 2: no cut
    with cell.mode:
        cut = TS.cache_blocks(cfg, mesh, cut_batch, seq, device="cpu")
        whole = TS.cache_blocks(uncut, mesh, 2, seq, device="cpu")
        short = TS.cache_blocks(cfg, mesh, cut_batch, seq // 2, device="cpu")
        steps = (TS.make_serve_step(cfg, mesh, cell.specs, batch=cut_batch, s_max=seq),
                 TS.make_serve_step(uncut, mesh, cell.specs, batch=2, s_max=seq))
        for step, caches in ((steps[0], whole), (steps[0], short), (steps[1], cut)):
            with pytest.raises(ValueError, match="slots"):
                step(None, caches, None, None)


class Collectives(torch.utils._python_dispatch.TorchDispatchMode):
    """(kind, input numel, output numel) of every collective."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = OC.COLLECTIVES.get(func._schema.name)
        if kind is not None:
            k, o, i = kind
            n_in = sum(t.numel() for t in torch.utils._pytree.tree_leaves(args[i])
                       if isinstance(t, torch.Tensor))
            n_out = n_in if o is None else sum(
                t.numel() for t in torch.utils._pytree.tree_leaves(args[o])
                if isinstance(t, torch.Tensor))
            self.seen.append((k, n_in, n_out))
        return func(*args, **(kwargs or {}))


def test_seq_parallel_train_cell_saves_blocks_and_scatters(fake_world):
    """A shrink(stablelm) train cell of 8 layers over a (1, 4) fake world
    (every collective over ``model``), remat "dots": with
    ``seq_parallel`` each remat region saves the rank's block of the
    sequence, so the census's peak falls below the cell's without it;
    the stream's collectives are an all-gather before each block and a
    reduce-scatter after it, where the cell without it all-reduces the
    whole (B, S, D) stream after each block, forward and backward."""
    fake_world(4)
    mesh = TM.make_mesh((1, 4), ("data", "model"), device="cpu")
    arch = TC.get_arch("stablelm-1.6b")
    spec = dataclasses.replace(arch, model=TC.shrink(arch.model, blocks=((
        arch.model.blocks[0][0], 8),)))
    seq, batch = 256, 2
    hidden = batch * seq * spec.model.d_model
    out = {}
    for sp in (False, True):
        cell = TS.build_cell(spec, "train_4k", mesh, overrides={"seq_parallel": sp},
                             shape=(seq, batch, "train"))
        assert cell.model_cfg.remat == "dots"
        assert ("block of the sequence" in cell.layout["stream"]) == sp
        with cell.mode:
            with OC.op_census(*cell.args) as c, Collectives() as coll:
                cell.fn(*cell.args)
        out[sp] = (c.result(), coll.seen)
    (off, seen_off), (on, seen_on) = out[False], out[True]
    n = spec.model.n_layers
    assert on["peak"] < off["peak"]
    assert sum(s == ("all-reduce", hidden, hidden) for s in seen_off) >= 2 * 2 * n
    assert not any(k == "all-reduce" and i == hidden for k, i, _ in seen_on)
    assert sum(s == ("all-gather", hidden // 4, hidden) for s in seen_on) >= 2 * n
    assert sum(s == ("reduce-scatter", hidden, hidden // 4) for s in seen_on) >= 2 * n


def test_moe_without_ep_cell_keeps_expert_stacks_cut_over_model(fake_world):
    """A batch-1 decode cell of shrink(jamba) over a 2 x 2 fake world
    (``moe_ep`` off, as the dry run sets it below batch 16): every expert
    stack the specs cut over ``model`` is gathered over ``data`` only,
    the rank computing its E/2 experts' rows; the plan keeps them so."""
    from repro_torch.distributed import sharded
    from torch_train_worker import gathered_axes
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    cell = TS.build_cell(small("jamba-v0.1-52b"), "long_500k", mesh, shape=(64, 1, "decode"))
    cfg = cell.model_cfg
    assert not cfg.moe_ep and cfg.n_experts % 2 == 0
    stacks = [p for p in sharded.spec_paths(cell.specs)
              if "/mlp/" in p and p.rsplit("/", 1)[-1] in M.EXPERT_STACKS]
    assert stacks
    plan = M.sharding(cfg, mesh, cell.specs)
    assert all(plan.gathers[p][2] == ("model",) for p in stacks)
    with cell.mode, gathered_axes(cell.parts["params"]) as axes:
        cell.fn(*cell.args)
    assert all(axes[p] == {"data"} for p in stacks), {p: axes.get(p) for p in stacks}
