"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) on the CPU: the
reference's container properties (``tests/test_faults.py``'s ckpt cases,
ported), files crossing between the two packages in both directions and
across meshes, the elastic restore's fingerprint check, and the train
CLI's ``--zero``, ``--ckpt``, ``--ckpt-every`` and ``--resume`` on one
rank. Corruption is made with the JAX package's own
``faultinject.corrupt_checkpoint``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.core import faultinject as FI
from repro.core.partition import spec_tree_to_pspecs
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro.optim import adamw as JOPT
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import CheckpointError
from repro_torch.configs import get_config
from repro_torch.core.gradsync import GradSyncConfig
from repro_torch.core.mesh import MeshAxes
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.optim import adamw as OPT

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCH = "qwen3-1.7b"
CLI = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu", "--steps",
       "4", "--batch", "4", "--seq", "16", "--log-every", "1"]


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(64, 32).astype(np.float32)},
            "b": rng.randn(128).astype(np.float32),
            "scale": np.float32(rng.randn())}


# ---------------------------------------------------------------------- #
# the container (test_faults.py's cases)
# ---------------------------------------------------------------------- #

def test_ckpt_atomic_write_roundtrip_and_verify(tmp_path):
    path = str(tmp_path / "ck.npz")
    t = _tree()
    ckpt.save(path, t, step=7)
    # atomic rename left no temp debris
    assert [f for f in os.listdir(tmp_path) if ".tmp-" in f] == []
    got, step = ckpt.restore(path, t)
    assert step == 7
    for k in ("a/w", "b", "scale"):
        np.testing.assert_array_equal(ckpt._flatten(got)[k],
                                      ckpt._flatten(t)[k])
    assert ckpt.verify(path) == {"step": 7, "leaves": 3,
                                 "checksummed": True}


def test_ckpt_truncated_raises_container_error(tmp_path):
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, _tree())
    FI.corrupt_checkpoint(path, mode="truncate")
    with pytest.raises(CheckpointError,
                       match="unreadable .truncated or corrupt container"):
        ckpt.restore(path, _tree())
    with pytest.raises(CheckpointError):
        ckpt.verify(path)


def test_ckpt_bitflip_names_offending_leaf(tmp_path):
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, _tree())
    FI.corrupt_checkpoint(path, leaf="params/a/w")
    with pytest.raises(CheckpointError,
                       match=r"leaf 'params/a/w' is corrupt"):
        ckpt.restore(path, _tree())
    with pytest.raises(CheckpointError, match=r"params/a/w"):
        ckpt.verify(path)
    # the untouched sibling leaf is still readable on its own
    data, meta = ckpt._open(path)
    np.testing.assert_array_equal(
        ckpt._read_leaf(data, meta, "params/b"), _tree()["b"])


def test_ckpt_checksum_layer_catches_valid_zip(tmp_path, monkeypatch):
    """An intact zip whose recorded checksums disagree fails the port's
    own verification, naming the leaf."""
    path = str(tmp_path / "ck.npz")
    monkeypatch.setattr(ckpt, "_crc", lambda arr: 12345)
    ckpt.save(path, _tree())
    monkeypatch.undo()
    with pytest.raises(CheckpointError,
                       match=r"failed checksum verification "
                             r".recorded 0x00003039"):
        ckpt.restore(path, _tree())


def test_ckpt_legacy_without_checksums_still_restores(tmp_path):
    path = str(tmp_path / "ck.npz")
    legacy = str(tmp_path / "legacy.npz")
    ckpt.save(path, _tree(), step=3)
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    del meta["checksums"]
    arrays = {k: data[k] for k in data.files if k != "__meta__"}
    with open(legacy, "wb") as fh:
        np.savez(fh, __meta__=json.dumps(meta), **arrays)
    got, step = ckpt.restore(legacy, _tree())
    assert step == 3
    np.testing.assert_array_equal(got["a"]["w"], _tree()["a"]["w"])
    assert ckpt.verify(legacy)["checksummed"] is False


def test_ckpt_missing_leaf_is_keyerror(tmp_path):
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, {"a": np.zeros(4, np.float32)})
    with pytest.raises(KeyError, match="checkpoint missing leaf"):
        ckpt.restore(path, {"a": np.zeros(4, np.float32),
                            "extra": np.zeros(2, np.float32)})


# ---------------------------------------------------------------------- #
# both directions, across meshes
# ---------------------------------------------------------------------- #

def _jax_side(kw=None):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **(kw or {}))
    mesh = LM.make_smoke_mesh((1, 1, 1, 1))
    axes = LM.bind_4d(mesh)
    params, specs = JST.init_model(jcfg, axes, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
    return jcfg, jax.tree.map(np.asarray, params), specs


def _trained_port_model(tree, tcfg):
    """The JAX weights after one port train step (so m, v and the step
    are not zero), and its replicated-layout state."""
    model = convert.params_from_jax(tree, tcfg, "cpu")
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, MeshAxes(), OPT.AdamWConfig(),
                              ST.TrainOptions(dtype=torch.float32))
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, tcfg.vocab_size, (4, 16)))
    step(model, state, {"tokens": toks, "labels": toks})
    return model, state


def test_a_port_file_reads_in_the_reference(tmp_path):
    """``repro.checkpoint.ckpt`` verifies a port checkpoint and restores
    it into its own trees: the same keys as its own file of the same
    trees, the same ``specs`` strings and equal arrays."""
    jcfg, tree, specs = _jax_side()
    tcfg = get_config(ARCH).reduced()
    model, state = _trained_port_model(tree, tcfg)
    path = str(tmp_path / "port.npz")
    ckpt.save(path, convert.params_to_jax(model),
              convert.opt_state_to_jax(state, model), step=5,
              pspecs=convert.jax_specs(model), extra={"mesh": [1, 1, 1, 1]})
    assert jckpt.verify(path) == {"step": 5, "leaves": 4 * len(
        jax.tree.leaves(tree)) + 1, "checksummed": True}
    structs = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           tree)
    jparams, step = jckpt.restore(path, structs)
    like_state = JOPT.init_state(structs, abstract=True)
    jstate, _ = jckpt.restore(path, like_state, root="opt_state")
    assert step == 5 and int(jstate["step"]) == 1
    ref = str(tmp_path / "ref.npz")
    jckpt.save(ref, jparams, jstate, step=5,
               pspecs=spec_tree_to_pspecs(specs))
    mine, theirs = (json.loads(str(np.load(p)["__meta__"]))
                    for p in (path, ref))
    assert mine["keys"] == theirs["keys"]
    assert mine["specs"] == theirs["specs"]
    for k in mine["keys"]:
        np.testing.assert_array_equal(np.load(path)[k], np.load(ref)[k])
    params = dict(model.named_parameters())
    paths = convert.jax_paths(model)
    for n, p in params.items():
        leaf = jparams
        for k in paths[n].split("/"):
            leaf = leaf[k]
        if n.startswith("layers."):
            leaf = leaf[int(n.split(".")[1])]
        np.testing.assert_array_equal(np.asarray(leaf), p.detach().numpy())


@pytest.mark.parametrize("sizes", [(2, 2, 1, 1), (1, 1, 2, 2)], ids=str)
def test_a_reference_file_restores_into_the_port_on_another_mesh(
        tmp_path, sizes):
    """A file the reference wrote on one device restores into the port on
    a mesh: every rank's parameter and state blocks are the blocks of the
    reference's arrays (``params_from_jax``'s slicing)."""
    jcfg, tree, specs = _jax_side()
    structs = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           tree)
    jstate = JOPT.init_state(jax.tree.map(jnp.asarray, tree))
    jstate = {"opt": jax.tree.map(lambda a: np.asarray(a) + 0.5,
                                  jstate["opt"]),
              "step": np.asarray(4, np.int32)}
    path = str(tmp_path / "ref.npz")
    jckpt.save(path, tree, jstate, step=9,
               pspecs=spec_tree_to_pspecs(specs))
    tcfg = get_config(ARCH).reduced()
    axes = MeshAxes(sizes)
    model = ST.init_model(tcfg, axes, device="cpu")
    params, step = ckpt.restore(path, convert.jax_structs(model))
    full, _ = ckpt.restore(path, convert.jax_opt_structs(model),
                           root="opt_state")
    assert step == 9
    for rank in range(axes.world):
        want = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
        convert.load_params_from_jax(model, params, rank=rank)
        got = convert.opt_state_from_jax(full, model, rank=rank)
        assert got["step"] == 4
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  want.named_parameters()):
            assert torch.equal(p, q), (rank, n)
            assert torch.equal(got["opt"][n]["master"], q + 0.5), (rank, n)


def test_restore_refuses_a_changed_fingerprint():
    """An in-memory snapshot of a ZeRO plan re-shards onto another g_data
    but not onto another tensor partitioning, in the reference's words."""
    tcfg = get_config(ARCH).reduced()
    opts = ST.TrainOptions(dtype=torch.float32,
                           gradsync=GradSyncConfig(zero=True))

    def tools_on(sizes):
        axes = MeshAxes(sizes)
        model = ST.init_model(tcfg, axes, device="cpu")
        return model, ST.make_gradsync_tools(
            tcfg, axes, dict(model.named_parameters()), opts)
    _, tools = tools_on((2, 1, 1, 1))
    model, other = tools_on((2, 2, 1, 1))
    _, same = tools_on((4, 1, 1, 1))
    one = ST.init_model(tcfg, device="cpu")
    snap = {"params": convert.params_to_jax(one),
            "opt_state": convert.opt_state_to_jax(OPT.init_state(dict(
                one.named_parameters())), one),
            "step": 0,
            "fingerprint": ST.GS.plan_fingerprint(tools.plan)}
    assert ST.GS.plan_fingerprint(same.plan) == snap["fingerprint"]
    with pytest.raises(ValueError, match="elastic restore: bucket-plan "
                       "fingerprint .* the rebuild changed the tensor "
                       "partitioning"):
        ST.restore_state(snap, tcfg, MeshAxes((2, 2, 1, 1)), other, opts,
                         model)


def test_save_sharded_and_restore_sharded_round_trip(tmp_path):
    """A ZeRO-1 state saved through its gather tool (into the replicated
    layout) and restored through a scatter tool gives back the same
    shards, the parameters and the step."""
    tcfg = get_config(ARCH).reduced()
    opts = ST.TrainOptions(dtype=torch.float32,
                           gradsync=GradSyncConfig(zero=True,
                                                   bucket_mb=0.25))
    model, _ = _trained_port_model(_jax_side()[1], tcfg)
    params = dict(model.named_parameters())
    tools = ST.make_gradsync_tools(tcfg, MeshAxes(), params, opts)
    state = tools.init(params)
    for b in state["buckets"]:
        b["m"].add_(1.5)
        b["v"].add_(0.25)
    state["step"] = 7
    path = str(tmp_path / "zero.npz")
    ckpt.save_sharded(path, convert.params_to_jax(model), state,
                      lambda s: convert.opt_state_to_jax(tools.gather(s),
                                                         model), step=6,
                      pspecs=convert.jax_specs(model))
    assert json.loads(str(np.load(path)["__meta__"]))["extra"] == {
        "zero": True}
    tree, got, step = ckpt.restore_sharded(
        path, convert.jax_structs(model), convert.jax_opt_structs(model),
        lambda full: tools.scatter(convert.opt_state_from_jax(full, model)))
    assert step == 6 and got["step"] == 7
    for b, g in zip(state["buckets"], got["buckets"]):
        assert all(torch.equal(b[k], g[k]) for k in ("m", "v", "master"))
    want = convert.params_to_jax(model)
    for k, v in convert._flat_tree(want).items():
        np.testing.assert_array_equal(convert._flat_tree(tree)[k], v)


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #

def test_train_cli_zero_ckpt_every_and_resume(tmp_path):
    """``--zero --ckpt --ckpt-every 2`` stopped after 3 of 4 steps, then
    ``--resume`` without ``--zero``: the resumed run starts at step 3 (the
    saved step + 1) and its step matches the uninterrupted run's; the
    file verifies, records the reference's extra and holds the state of
    the step it names."""
    path = str(tmp_path / "run.npz")
    full = train.main(CLI)
    cut = train.main([*CLI, "--zero", "--ckpt", path, "--ckpt-every", "2",
                      "--dp-bucket-mb", "0.25"], stop_after=3)
    assert len(cut.ckpt["save_s"]) == 2 and cut.ckpt["bytes"] > 0
    assert cut.losses == pytest.approx(full.losses[:3], rel=1e-6)
    info = ckpt.verify(path)
    assert info["step"] == 2 and info["checksummed"]
    meta = json.loads(str(np.load(path)["__meta__"]))
    assert meta["extra"] == {"dp_bucket_mb": 0.25, "zero3": False,
                             "mesh": [1, 1, 1, 1], "zero": True}
    assert int(np.load(path)["opt_state/step"]) == 3
    res = train.main([*CLI, "--ckpt", path, "--resume"])
    assert res.first_step == 3 and len(res.losses) == 1
    assert res.ckpt["restore_s"] > 0
    assert abs(res.losses[0] - full.losses[3]) < 1e-5
    assert abs(res.grad_norms[0] - full.grad_norms[3]) < 1e-4 * \
        full.grad_norms[3]
    assert ckpt.verify(path)["step"] == 3


def test_train_cli_resume_needs_ckpt():
    with pytest.raises(SystemExit, match="--resume needs --ckpt"):
        train.main([*CLI, "--resume"])
