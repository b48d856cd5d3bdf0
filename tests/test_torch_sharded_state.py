"""The training state held as each rank's blocks (``distributed.sharded``,
``make_train_step(..., specs=)``, ``build_state(..., mesh=)``, the
checkpoints' sharded form) on the CPU: over gloo process groups of
subprocesses at world sizes 2 and 4 (``torch_train_worker.py sharded``),
against the same steps with the whole state on every rank, against the
reference's train step from the same state, and the blocks against the
reference's own ``NamedSharding`` (a subprocess with four host devices).

Four families at ``shrink()`` sizes: stablelm (dense), deepseek (MLA and
the MoE, expert-parallel over ``model``), jamba (Mamba, attention, the
MoE) and whisper (encoder-decoder); AdamW and Adafactor; meshes (2, 1),
(1, 2) and (2, 2).  Tolerances:

* AdamW without the clip, over a mesh whose ``model`` axis has one
  rank: the blocks' steps equal the whole form's bit for bit, losses and
  state, at both world sizes.  Both forms add the same two terms per
  gradient element (a data group of two) and the update is elementwise.
  Where ``model`` has two ranks the blocks' compute is cut over it
  (tensor parallelism, which adds partial products in another order):
  the losses hold the whole form's at rtol = atol = 1e-5, and every
  element of the state (parameters, moments) the whole form's within
  lr / 4 = 2.5e-4 (``STATE_ATOL``).  AdamW's first step moves an element
  by lr·g/(|g| + eps), eps = 1e-8, so where a gradient is near 0 a
  rounding-level difference δ of it moves the parameter by up to about
  lr·δ/(δ/2 + eps): shrink(jamba) over (1, 2) has an element of w_down
  whose first gradient is 1.09e-8 in one order and 8.0e-9 in the other
  (its leaf's largest 3.3e-3), and ends 7.65e-5 apart; a wrong update
  moves an element by about lr = 1e-3.  ``test_torch_tensor_parallel.py``
  holds its gradients.
* With the clip, and with Adafactor: the global norm and Adafactor's
  factored means and RMS clip are sums that the blocks add in another
  order (a partial sum per block, then the group's), so the losses hold
  the whole form's at rtol = atol = 1e-5, and a norm, statistic or
  update of blocks holds the whole leaf's at 1e-6 of its largest value.
* Against the reference's step: rtol = atol = 2e-4, the contract of
  ``tests/test_torch_train.py``.

Every rendezvous goes through a file under the test's temporary
directory; every subprocess has a timeout.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import model as RM
from repro.optim import OptConfig as RefOptConfig
from repro.optim import optimizers as RO
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch._tree import flatten
from repro_torch.checkpoint import restore_state, save_state
from repro_torch.distributed import sharded
from repro_torch.launch import mesh as TM
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.optim import OptConfig
from test_torch_model import configs, inputs
from torch_train_worker import (BATCH, BLOCK_MESHES, CKPT_ARCH, CKPT_MESH, FAMILIES, KINDS,
                                REMAT_ARCH, SHARDED_MESHES, SEQ, STEPS, family_cfg, opt_cfg,
                                run_steps)

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
WORKER = Path(__file__).resolve().parent / "torch_train_worker.py"
TIMEOUT_S = 240
REF_TOL = dict(rtol=2e-4, atol=2e-4)
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
#: The state after AdamW steps whose compute is cut over ``model``,
#: element by element against the whole form's (the module's docstring):
#: lr / 4, below the lr (1e-3) that a wrong update moves by.
STATE_ATOL = 2.5e-4
REDUCE_REL = 1e-6

JAX_BLOCKS = """
import pickle, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
data = pickle.loads(open(sys.argv[1], "rb").read())
out = {}
for key, (shape, names, leaves) in data.items():
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devs, names)
    rank = {d.id: r for r, d in enumerate(devs.flat)}   # row-major, as the port's ranks
    out[key] = {}
    for path, (a, spec) in leaves.items():
        x = jax.device_put(a, NamedSharding(mesh, P(*spec)))
        for sh in x.addressable_shards:
            out[key].setdefault(rank[sh.device.id], {})[path] = np.asarray(sh.data)
open(sys.argv[2], "wb").write(pickle.dumps(out))
"""


def ref_cfgs(arch):
    """(the reference's, the port's) shrink() configs of a family, the
    MoE at capacity factor E/k on both sides (moe_ep is the port's
    layout and changes no value)."""
    rcfg, _ = configs(arch)
    if rcfg.n_experts:
        rcfg = dataclasses.replace(rcfg, capacity_factor=rcfg.n_experts / rcfg.top_k)
    return rcfg, family_cfg(arch)


def family_data(arch):
    """The reference's initial state per optimizer (its ``init_params``
    and ``init_opt_state``, as numpy) and three steps' batches."""
    rcfg, cfg = ref_cfgs(arch)
    toks, stub = inputs(cfg, STEPS * BATCH, SEQ + 1, seed=4)
    out = {"tokens": toks.reshape(STEPS, BATCH, SEQ + 1), "state": {}}
    if "enc_frames" in stub:
        out["frames"] = stub["enc_frames"].reshape(STEPS, BATCH, *stub["enc_frames"].shape[1:])
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    for kind in KINDS:
        opt = RO.init_opt_state(params, RefOptConfig(**dataclasses.asdict(opt_cfg(kind))))
        out["state"][kind] = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    return out


def ref_losses(arch, data):
    """The reference's train step (``value_and_grad(lm_loss)``, then
    ``opt_update`` and ``apply_updates``, each jitted) from each initial
    state over the three whole batches."""
    rcfg, _ = ref_cfgs(arch)
    loss_grad = jax.jit(jax.value_and_grad(RM.lm_loss), static_argnums=(1,))
    update = jax.jit(RO.opt_update, static_argnums=(3,))
    apply = jax.jit(RO.apply_updates)
    out = {}
    for kind in KINDS:
        ocfg = RefOptConfig(**dataclasses.asdict(opt_cfg(kind)))
        st = jax.tree.map(jnp.asarray, data["state"][kind])
        params, opt, losses = st["params"], st["opt"], []
        for s in range(STEPS):
            b = {"tokens": jnp.asarray(data["tokens"][s])}
            if "frames" in data:
                b["audio_frames"] = jnp.asarray(data["frames"][s])
            loss, g = loss_grad(params, rcfg, b)
            upd, opt = update(g, params, opt, ocfg)
            params = apply(params, upd)
            losses.append(float(loss))
        out[kind] = losses
    return out


def block_inputs(data):
    """deepseek's whole parameters (the port's leaves, numpy) with their
    specs over each mesh of the block-order check."""
    params = interop.model_params_from_jax(data["state"]["adamw"]["params"],
                                           family_cfg("deepseek-v2-lite-16b"), device="cpu")
    whole = {p: t.numpy() for p, t in flatten(params).items()}
    out = {}
    for meshes in BLOCK_MESHES.values():
        for key, (shape, names) in meshes.items():
            specs = sharded.spec_paths(TS.param_specs(params, family_cfg("deepseek-v2-lite-16b"),
                                                      (shape, names)))
            out[key] = (shape, names, {p: (whole[p], specs[p]) for p in whole})
    return out


def write_world_one_checkpoint(root, data):
    """The world-1 checkpoint the workers restore: stablelm with AdamW
    (no clip) after one whole step on the whole first batch."""
    cfg, ocfg = family_cfg(CKPT_ARCH), opt_cfg("adamw", clip=0.0)
    state = TT.build_state(cfg, ocfg, seed=6, device="cpu")
    TS.make_train_step(cfg, ocfg)(state, {"tokens": torch.as_tensor(data["tokens"][0])})
    save_state(root, 1, state, {"data_step": 1})


def _launch(args, env, log):
    return subprocess.Popen([sys.executable, *args], env=env, stdout=log,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers at world sizes 2 and 4 and the reference's blocks, run
    at once while this process computes the reference's losses."""
    base = tmp_path_factory.mktemp("sharded_state")
    fam = {arch: family_data(arch) for arch in FAMILIES}
    blocks = block_inputs(fam["deepseek-v2-lite-16b"])
    write_world_one_checkpoint(base / "ckpt1", fam[CKPT_ARCH])
    data = {"families": fam, "ckpt": str(base / "ckpt1"),
            "blocks": {k: {p: leaf for p, leaf in v[2].items()} for k, v in blocks.items()}}
    (base / "data.pkl").write_bytes(pickle.dumps(data))
    (base / "jax_in.pkl").write_bytes(pickle.dumps(blocks))
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs, logs = [], []
    for world in (2, 4):
        (base / f"w{world}").mkdir()
        for r in range(world):
            logs.append(open(base / f"w{world}" / f"log{r}.txt", "w"))
            procs.append(_launch([str(WORKER), str(r), str(world), str(base / f"w{world}" / "init"),
                                  str(base / f"w{world}"), "sharded", str(base / "data.pkl")],
                                 env, logs[-1]))
    logs.append(open(base / "jax_log.txt", "w"))
    procs.append(_launch(["-c", JAX_BLOCKS, str(base / "jax_in.pkl"), str(base / "jax_out.pkl")],
                         dict(os.environ, JAX_PLATFORMS="cpu",
                              XLA_FLAGS="--xla_force_host_platform_device_count=4"), logs[-1]))
    try:
        ref = {arch: ref_losses(arch, fam[arch]) for arch in FAMILIES}
        for p, log in zip(procs, logs):
            p.wait(timeout=TIMEOUT_S)
            log.close()
            assert p.returncode == 0, Path(log.name).read_text()[-4000:]
    finally:
        for p in procs:
            p.kill()
    out = {w: [pickle.loads((base / f"w{w}" / f"sharded{r}.pkl").read_bytes())
               for r in range(w)] for w in (2, 4)}
    return {"ranks": out, "ref": ref, "jax": pickle.loads((base / "jax_out.pkl").read_bytes()),
            "base": base, "blocks": blocks}


def each_family_run(run, arch):
    """(world, mesh shape, rank, record) of every run of ``arch``."""
    for world, recs in run["ranks"].items():
        for shape in SHARDED_MESHES[world]:
            for r, rec in enumerate(recs):
                yield world, shape, r, rec["families"][(arch, shape)]


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("key", [k for m in BLOCK_MESHES.values() for k in m])
def test_blocks_equal_jax_addressable_shards(run, key):
    """Each rank's block of every deepseek leaf equals the shard that
    jax's ``NamedSharding(mesh, spec)`` puts on the device at that rank's
    mesh coordinate; the (2, 2, 1) mesh cuts dims over ("pod", "data"),
    pod major."""
    world = next(w for w, m in BLOCK_MESHES.items() if key in m)
    want = run["jax"][key]
    for r, rec in enumerate(run["ranks"][world]):
        got = rec["blocks"][key]
        assert got.keys() == want[r].keys()
        for path, block in got.items():
            np.testing.assert_array_equal(block, want[r][path], err_msg=f"rank {r} {path}")
    specs = [spec for _, spec in run["blocks"][key][2].values()]
    assert any(e is not None for spec in specs for e in spec)
    if key == "pod2x2x1":
        assert any(("pod", "data") in spec for spec in specs)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_state_bytes_equal_bytes_under_specs(run, arch, kind):
    """Every rank stores exactly what the reference's specs give it."""
    for world, shape, r, rec in each_family_run(run, arch):
        assert rec[kind]["bytes"] == rec[kind]["under_specs"] > 0, (world, shape, r)


# ------------------------------------------------------------------- steps
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_steps_equal_the_whole_form(run, arch):
    """AdamW without the clip: the blocks start as the whole state cut,
    and three steps give the whole form's losses and state bit for bit at
    world sizes 2 and 4 where the mesh's ``model`` axis has one rank, and
    where the compute is cut over two the losses within ORDER_TOL and
    every element of the state within STATE_ATOL
    (deepseek's also with remat "full" and "dots", whose regions gather
    again in the backward, bit for bit against no remat); with the clip
    and with Adafactor, the losses within ORDER_TOL.  Every rank reports
    the same losses."""
    for world, shape, r, rec in each_family_run(run, arch):
        assert rec["init_equal"], (world, shape, r)
        if shape[1] == 1:
            assert rec["exact"]["blocks"] == rec["exact"]["whole"], (world, shape, r)
            assert rec["exact"]["state_equal"], (world, shape, r)
        else:
            np.testing.assert_allclose(rec["exact"]["blocks"], rec["exact"]["whole"],
                                       **ORDER_TOL, err_msg=f"world {world} mesh {shape}")
            path, (worst, _) = max(rec["exact"]["state_spread"].items(), key=lambda kv: kv[1][0])
            assert worst <= STATE_ATOL, (world, shape, r, path, worst)
        for remat in ("full", "dots") if arch == REMAT_ARCH else ():
            assert rec["exact"][remat] == rec["exact"]["blocks"], (world, shape, r, remat)
        for kind in KINDS:
            np.testing.assert_allclose(rec[kind]["blocks"], rec[kind]["whole"], **ORDER_TOL)
        first = run["ranks"][world][0]["families"][(arch, shape)]
        assert rec["exact"]["blocks"] == first["exact"]["blocks"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_steps_match_reference(run, arch, kind):
    """Three steps of the blocks from the reference's initial state
    (``interop.train_state_from_jax(..., mesh=)``) against the
    reference's three steps on the whole batches."""
    want = run["ref"][arch][kind]
    for world, shape, r, rec in each_family_run(run, arch):
        np.testing.assert_allclose(rec[kind]["blocks"], want, **REF_TOL,
                                   err_msg=f"world {world} mesh {shape} rank {r}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_norm_and_adafactor_statistics_of_blocks(run, arch):
    """``global_norm`` of blocks (squares all-reduced over the axes each
    leaf is cut over) and one Adafactor update of blocks (factored means
    and clip summed over the group), gathered, against the whole leaves'
    on the same seeded gradients."""
    for world, shape, r, rec in each_family_run(run, arch):
        red = rec["reductions"]
        assert max(red.values()) <= REDUCE_REL, (world, shape, r, red)


# ------------------------------------------------------------- checkpoints
def leaves_of(step_dir):
    """(extras, {path: (dtype, shape, array)}) of a checkpoint directory."""
    manifest = json.loads((step_dir / "manifest.json").read_text())
    return manifest["extras"], {
        rec["path"]: (rec["dtype"], rec["shape"], np.load(step_dir / f"arr_{rec['index']:06d}.npy"))
        for rec in manifest["leaves"]}


def assert_same_files(a, b):
    ea, la = leaves_of(a)
    eb, lb = leaves_of(b)
    assert ea == eb and la.keys() == lb.keys()
    for path in la:
        assert la[path][:2] == lb[path][:2], path
        assert la[path][2].dtype == lb[path][2].dtype
        assert la[path][2].tobytes() == lb[path][2].tobytes(), path


def assert_close_files(a, b):
    """The same leaves, dtypes and shapes, each element within STATE_ATOL."""
    ea, la = leaves_of(a)
    eb, lb = leaves_of(b)
    assert ea == eb and la.keys() == lb.keys()
    for path in la:
        assert la[path][:2] == lb[path][:2], path
        np.testing.assert_allclose(la[path][2], lb[path][2], rtol=0, atol=STATE_ATOL,
                                   err_msg=path)


def test_checkpoints_restore_across_world_sizes(run):
    """A world-1 checkpoint restored as blocks at world sizes 2 and 4
    equals the whole leaves cut, and saved again from the blocks it is
    the same files, bit for bit; restoring those at world 1 (here, whole)
    and so at any world size gives the same state.  After two more steps
    the blocks' async save equals a whole save of the blocks gathered,
    bit for bit; over (2, 1) the steps are bit for bit the whole form's
    (AdamW without the clip) and so is the save, and over (2, 2), whose
    compute is cut over ``model``, the losses hold the whole form's within
    ORDER_TOL and every element of the save the whole form's within
    STATE_ATOL."""
    base = run["base"]
    cfg, ocfg = family_cfg(CKPT_ARCH), opt_cfg("adamw", clip=0.0)
    for world in (2, 4):
        tp = CKPT_MESH[world][1] > 1
        for r, rec in enumerate(run["ranks"][world]):
            assert rec["ckpt"]["cut_equal"], (world, r)
            losses = rec["ckpt"]["losses"]
            if tp:
                np.testing.assert_allclose(losses["blocks"], losses["whole"], **ORDER_TOL)
            else:
                assert losses["blocks"] == losses["whole"], (world, r)
        assert_same_files(base / f"w{world}" / f"ckpt{world}" / "step_000000001",
                          base / "ckpt1" / "step_000000001")
        assert_same_files(base / f"w{world}" / f"ckpt{world}" / "step_000000003",
                          base / f"w{world}" / f"ckpt{world}" / "gathered" / "step_000000003")
        if tp:
            assert_close_files(base / f"w{world}" / f"ckpt{world}" / "step_000000003",
                               base / f"w{world}" / f"ckpt{world}" / "whole" / "step_000000003")
        else:
            assert_same_files(base / f"w{world}" / f"ckpt{world}" / "step_000000003",
                              base / f"w{world}" / f"ckpt{world}" / "whole" / "step_000000003")
        like = TT.build_state(cfg, ocfg, seed=1, device="cpu")
        got, extras = restore_state(base / f"w{world}" / f"ckpt{world}", 1, like)
        want, _ = restore_state(base / "ckpt1", 1, like)
        assert extras == {"data_step": 1}
        assert all(torch.equal(a, b) for a, b in zip(flatten(got).values(),
                                                      flatten(want).values()))


def test_sharded_resume_gives_identical_losses(run):
    """launch.train.main under a gloo group (blocks, (2, 1) and (2, 2)
    meshes): a checkpoint at step 3, then --resume gives steps 3 and 4's
    losses again, bit for bit."""
    for world in (2, 4):
        for rec in run["ranks"][world]:
            assert len(rec["resume"]["first"]) == 5
            assert rec["resume"]["resumed"] == rec["resume"]["first"][3:]


# ---------------------------------------------------------- in this process
@pytest.fixture
def fake_world():
    yield TM.start_fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


class AllReduces(torch.utils._python_dispatch.TorchDispatchMode):
    """The shapes of every all-reduce's tensors, and each one's bytes on
    the wire (the census's ring model over the op's group)."""

    def __init__(self):
        super().__init__()
        self.shapes, self.wire = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in ("c10d::allreduce_", "c10d::allreduce_coalesced_"):
            from repro_torch.launch.opcensus import _group_size, wire_bytes
            n = _group_size(args)
            for t in args[0]:
                b = t.numel() * t.element_size()
                self.shapes.append(tuple(t.shape))
                self.wire.append(wire_bytes("all-reduce", b, b, n))
        return func(*args, **(kwargs or {}))

    def wire_of(self, shapes) -> float:
        """The wire bytes of the all-reduces of tensors of ``shapes``."""
        return sum(w for s, w in zip(self.shapes, self.wire) if s in shapes)


def test_census_has_no_all_reduce_of_expert_stacks(fake_world):
    """shrink(deepseek) with moe_ep over a (2, 2) fake world, one step
    under the census: the sharded step all-reduces no expert stack (its
    slices' gradients are reduce-scattered over ``data``), where the whole
    form all-reduces every (E, D, F) stack over ``model`` and ``data``, at
    least the stacks' ring cost on the wire.  (The sharded step's own
    all-reduces are the tensor-parallel sums of its hidden states over
    ``model`` and the gradients of the leaves it does not cut.)"""
    fake_world(4)
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    spec = TC.get_arch("deepseek-v2-lite-16b")
    spec = dataclasses.replace(spec, model=TC.shrink(spec.model))
    cell = TS.build_cell(spec, "train_4k", mesh, shape=(64, 16, "train"))
    cfg, ocfg = cell.model_cfg, cell.ocfg
    assert cfg.moe_ep
    E = cfg.n_experts
    stacks = [t for p, t in flatten(cell.whole["params"]).items()
              if p.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down") and t.dim() == 3]
    stack_shapes = {tuple(t.shape) for t in stacks}
    assert stacks and all(s[0] == E for s in stack_shapes)
    from repro_torch.launch.opcensus import op_census
    with cell.mode:
        with op_census(*cell.args) as c, AllReduces() as seen:
            cell.fn(*cell.args)
        sharded_wire = c.result()["wire"]
        assert not stack_shapes & set(seen.shapes)
        assert not any(len(s) == 3 and s[0] in (E, E // 2) for s in seen.shapes)
        # the whole form over the same mesh, for contrast
        whole = cell.whole
        for t in flatten(whole["params"]).values():
            t.requires_grad_(True)
        step = TS.make_train_step(cfg, ocfg, mesh, 16)
        with op_census(whole, cell.args[1]) as w, AllReduces() as seen_whole:
            step(whole, cell.args[1])
    assert stack_shapes <= set(seen_whole.shapes)
    stack_bytes = sum(t.numel() * t.element_size() for t in stacks)
    ring = 2 * stack_bytes * (2 - 1) / 2        # one all-reduce over a group of 2
    assert seen_whole.wire_of(stack_shapes) >= 2 * ring - 1
    assert seen.wire_of(stack_shapes) == 0
    assert w.result()["wire"]["all-reduce"] >= sum(seen_whole.wire) > 0
    assert {"all-gather", "reduce-scatter"} <= set(sharded_wire)


def test_build_state_holds_one_whole_leaf_at_a_time(fake_world, monkeypatch):
    """build_state under a mesh draws each leaf whole and keeps its block:
    when the next leaf is cut no earlier cut leaf is held whole, and the
    blocks equal the whole state cut, bit for bit, in the bytes the specs
    give (a (2, 1) mesh over a fake world, rank 0)."""
    fake_world(2)
    mesh = TM.make_mesh((2, 1), ("data", "model"), device="cpu")
    cfg, ocfg = family_cfg("jamba-v0.1-52b"), OptConfig(kind="adafactor")
    specs = TS.train_specs(cfg, ocfg, mesh)
    alive, real = [], sharded.shard_leaf
    worst, drawn = [0], [0]

    def spy(whole, spec, m):    # the cut leaves' wholes still held, this one counted
        drawn[0] += 1
        alive.append(weakref.ref(whole))
        worst[0] = max(worst[0], sum(w() is not None for w in alive))
        block = real(whole, spec, m)
        if block is whole:      # an uncut leaf: its block is the whole leaf
            alive.pop()
        return block

    monkeypatch.setattr(sharded, "shard_leaf", spy)
    st = TT.build_state(cfg, ocfg, seed=3, device="cpu", mesh=mesh, specs=specs)
    monkeypatch.undo()
    whole = TT.build_state(cfg, ocfg, seed=3, device="cpu")
    cut = sharded.shard_state(whole, specs, mesh)
    assert worst[0] == 1 and 0 < len(alive) < drawn[0] == len(flatten(whole["params"]))
    fb = flatten(cut)
    assert all(torch.equal(t, fb[p]) for p, t in flatten(st).items())
    assert sharded.block_bytes(st) == TS.bytes_under_specs(TS.state_shapes(cfg, ocfg), specs, mesh)
    assert sharded.block_bytes(st) < sharded.block_bytes(whole)


def test_one_rank_mesh_is_the_whole_state(fake_world):
    """Over a (1, 1) mesh every block is the whole leaf itself (no copy),
    the gather returns it as it is, and the steps equal the unsharded
    ones bit for bit."""
    fake_world(1)
    mesh = TM.make_mesh((1, 1), ("data", "model"), device="cpu")
    cfg, ocfg = family_cfg("deepseek-v2-lite-16b"), opt_cfg("adafactor")
    specs = TS.train_specs(cfg, ocfg, mesh)
    whole = TT.build_state(cfg, ocfg, seed=2, device="cpu")
    cut = sharded.shard_state(whole, specs, mesh)
    fw, fs = flatten(whole), sharded.spec_paths(specs)
    assert all(cut_t is fw[p] for p, cut_t in flatten(cut).items())
    assert all(sharded.gather(t, fs[f"params/{p}"], mesh) is t
               for p, t in flatten(cut["params"]).items())
    st = TT.build_state(cfg, ocfg, seed=2, device="cpu", mesh=mesh, specs=specs)
    data = {"tokens": np.random.default_rng(5).integers(0, cfg.vocab_size, (STEPS, BATCH, SEQ + 1))}
    assert run_steps(cfg, ocfg, mesh, st, data, specs) == run_steps(cfg, ocfg, mesh, whole, data)

