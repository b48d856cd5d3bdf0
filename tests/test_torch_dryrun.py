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
    assert 0 < bpd["state_under_specs"] < bpd[part]
    assert rec["flops"] > 0 and rec["bytes"] == pytest.approx(sum(rec["by_op"].values()))
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    if kind == "train":
        # the gradients' mean over data, the EP exchanges over model
        assert set(rec["collectives"]) == {"all-reduce", "all-to-all"}
        assert rec["optimizer"]["kind"] == "adamw"
    else:
        assert rec["collectives"] == {}
        caches = cell.parts["cache"]
        assert all(t.shape[0] == batch // 2 for c in caches for t in c.values())


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
    reference's tree path, are laid out by their stacked specs."""
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    cell = TS.build_cell(small("deepseek-v2-lite-16b"), "train_4k", mesh,
                         ocfg=OptConfig(kind="adafactor"))
    with cell.mode:
        state = cell.parts["state"]
        whole = sum(t.numel() * t.element_size() for t in flatten(state).values())
        under = TS.bytes_under_specs(state, cell.specs, mesh)
        v_whole = sum(t.numel() * t.element_size() for t in flatten(state["opt"]["v"]).values())
        v_under = TS.bytes_under_specs(state["opt"]["v"], cell.specs["opt"]["v"], mesh)
    assert 0 < under < whole and 0 < v_under < v_whole
