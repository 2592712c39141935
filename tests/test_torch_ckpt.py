"""Port parity: checkpoints (``repro_torch.ckpt``) against the reference's
``repro.ckpt``.

The reference's tests run on the port: round trip, a crashed writer's
``.tmp`` ignored, a directory without a manifest ignored, keep-k, async
save and wait, a leaf-count mismatch refused.  The layout is the
reference's, so a checkpoint either package writes restores in the other,
leaf for leaf and bit for bit: a smoke config's (values, AdamW state) in
both directions.  Restores cast to the target's dtype on its device (a
bfloat16 leaf, stored as float32, comes back exact), or, given
``shardings`` (a device on one card), keep the stored dtype there."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.ckpt import restore_checkpoint as jrestore
from repro.ckpt import save_checkpoint as jsave
from repro_torch import optim as topt
from repro_torch import params as tparams
from repro_torch import prng
from repro_torch.ckpt import (CheckpointManager, available_steps,
                              restore_checkpoint, save_checkpoint)
from repro_torch.ckpt.manager import describe
from repro_torch.models import lm
from test_torch_lm_train import one_torch_thread  # noqa: F401


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(
        np.float32)), "b": {"x": torch.arange(6, dtype=torch.float32)}}


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(topt.tree_leaves(a),
                                                 topt.tree_leaves(b)))


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 3, t)
    got, step = restore_checkpoint(tmp_path, t)
    assert step == 3 and _equal(got, t)
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json")
                          .read_text())
    assert manifest["n_leaves"] == 2
    assert manifest["treedef"] == describe(t) == "{'b': {'x': *}, 'w': *}"
    assert [l["shape"] for l in manifest["leaves"]] == [[6], [4, 8]]


def test_incomplete_tmp_ignored(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    bad = tmp_path / "step_000000002.tmp"
    bad.mkdir()
    (bad / "leaf_00000.npy").write_bytes(b"garbage")
    _, step = restore_checkpoint(tmp_path, t)
    assert step == 1 and available_steps(tmp_path) == [1]


def test_manifest_written_last_guards_partial_rename(tmp_path):
    d = tmp_path / "step_000000005"
    d.mkdir()
    np.save(d / "leaf_00000.npy", np.zeros(3))
    assert available_steps(tmp_path) == []
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, _tree())


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    (tmp_path / "step_000000009.tmp").mkdir()
    for s in range(5):
        mgr.save(s, _tree())
    assert available_steps(tmp_path) == [3, 4]
    assert not list(tmp_path.glob("*.tmp"))


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    t = _tree()
    mgr.save(7, t)
    mgr.save(8, _tree(1))            # waits for the first write
    mgr.wait()
    assert mgr.latest_step() == 8 and available_steps(tmp_path) == [7, 8]
    assert mgr.last_handoff_s >= 0 and mgr.last_write_s > 0
    got, step = mgr.restore(t, step=7)
    assert step == 7 and _equal(got, t)


def test_leaf_count_and_shape_mismatch_fail_loudly(tmp_path):
    save_checkpoint(tmp_path, 0, _tree())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, {"only": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaf 1"):
        restore_checkpoint(tmp_path, {"w": torch.zeros(4, 9),
                                      "b": {"x": torch.zeros(6)}})


def test_dtype_and_device_of_the_restore(tmp_path):
    """bfloat16 is stored as float32 (exactly) and restored as the
    target's dtype; ``shardings`` places the stored arrays on a device."""
    t = {"h": torch.randn(5, 3).to(torch.bfloat16),
         "n": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(tmp_path, 0, t)
    got, _ = restore_checkpoint(tmp_path, t)
    assert got["h"].dtype == torch.bfloat16 and _equal(got, t)
    placed, _ = restore_checkpoint(tmp_path, t, shardings="cpu")
    assert placed["h"].dtype == torch.float32
    assert torch.equal(placed["h"], t["h"].float())


@pytest.fixture(scope="module")
def smoke_state():
    """hymba-1.5b's smoke (values, AdamW state) one update in, so the
    moments are not zero: the port's, and the same as the reference's
    tree of arrays (the port's init is the reference's draws,
    ``test_torch_lm_models``)."""
    tc = dataclasses.replace(tconfigs.get_smoke("hymba-1.5b"),
                             dtype="float32")
    values = lm.build(tc, device="cpu").init(prng.PRNGKey(0))
    cfg = topt.AdamWConfig()
    grads = topt.tree_map(lambda x: torch.full_like(x, 0.01), values)
    tv, to = topt.adamw_update(grads, topt.adamw_init(values, cfg), values,
                               cfg)
    jv = jax.tree.map(jnp.asarray, tparams.lm_to_jax_values(tv))
    jo = {"count": jnp.asarray(int(to["count"]), jnp.int32),
          "m": jax.tree.map(jnp.asarray, tparams.lm_to_jax_values(to["m"])),
          "v": jax.tree.map(jnp.asarray, tparams.lm_to_jax_values(to["v"]))}
    return (jv, jo), (tv, to)


def test_reference_checkpoint_restores_in_the_port(tmp_path, smoke_state):
    jstate, tstate = smoke_state
    jsave(tmp_path, 4, jstate)
    like = topt.tree_map(torch.zeros_like, tstate)
    got, step = restore_checkpoint(tmp_path, like)
    assert step == 4
    want = jax.tree.leaves(jstate)
    got = topt.tree_leaves(got)
    assert len(got) == len(want) > 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_port_checkpoint_restores_in_the_reference(tmp_path, smoke_state):
    jstate, tstate = smoke_state
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(6, tstate)
    mgr.wait()
    like = jax.tree.map(jnp.zeros_like, jstate)
    got, step = jrestore(tmp_path, like)
    assert step == 6
    for g, w in zip(jax.tree.leaves(got), topt.tree_leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
