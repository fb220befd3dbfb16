"""Elastic scaling, held to the reference: ``tests/test_elastic.py``'s
scenario (a checkpoint taken on one mesh, restored onto another) across
both packages.

The reference (``tests/_torch_mesh.py``, 4 forced host devices, meshes
from ``build_mesh``) trains qwen1.5-0.5b's f32 smoke config on a (2, 2)
mesh, saving its initial state from the mesh with its own ``save_state``,
and takes 2 uninterrupted steps; it also restores its step-1 state onto
``plan_remesh(2, model=1)`` = (2, 1) and takes the second step there.  The
port, in a spawned 4-rank gloo world, restores the reference's checkpoint
(its stacked layout, read back by path) onto (2, 2) bit for bit, takes the
same 2 steps, saving its step-1 state from all 4 ranks (one host file a
rank, the union holding every leaf), then restores that onto (2, 1) over
ranks 0 and 1 (``runtime.build_mesh``) and onto one rank without a mesh,
each bit for bit, and takes the second step again.  Every second-step loss
matches the reference's uninterrupted one within 1e-4 relative.

Port-only: ``plan_remesh`` for every survivor count is the reference's
(``test_torch_specs.py``); a host file missing from a multi-host step is
refused.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh as M  # noqa: E402
from repro_torch.checkpoint import read_leaves, restore_state, save_state  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    np.savez(out / "batch_512.npz", **M.batch(512))
    M.run_reference(M.REF_ELASTIC, out, [])
    M.spawn_world(M.rank_elastic, 4, str(out))
    ref = dict(np.load(out / "elastic.npz"))
    port = json.loads((out / "elastic.port.json").read_text())
    return out, ref, port


def test_uninterrupted_steps_match_reference(runs):
    _, ref, port = runs
    for i in range(2):
        M.close(port["loss"][i], float(ref["loss"][i]), f"step {i + 1}")


def test_reference_checkpoint_restores_into_the_port(runs):
    _, _, port = runs
    assert port["ref_ckpt_exact"]


@pytest.mark.parametrize("where", ["remesh", "one"])
def test_restored_state_is_bit_exact(runs, where):
    _, _, port = runs
    assert port[f"{where}_exact"]


@pytest.mark.parametrize("where", ["remesh", "one"])
def test_step_after_restore_matches_uninterrupted(runs, where):
    _, ref, port = runs
    M.close(port[f"{where}_loss"], float(ref["loss"][1]), where)
    M.close(port[f"{where}_loss"], float(ref["remesh_loss"]),
            f"{where} vs the reference's re-mesh")


def test_remesh_plan_is_the_reference_s(runs):
    _, ref, port = runs
    assert port["plan"] == [2, 1] == list(ref["plan"])


def test_port_checkpoint_holds_every_leaf_once(runs):
    out = runs[0]
    d = out / "port_ckpt" / "step_000001"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    assert manifest["n_hosts"] == 4 and (d / "COMMIT").exists()
    keys = []
    for h in range(4):
        with np.load(d / f"host_{h:03d}.npz") as z:
            assert z.files, h
            keys.extend(z.files)
            for k in z.files:   # global shapes, sharded leaves included
                assert list(z[k].shape) == manifest["leaves"][k]["shape"], k
    assert sorted(keys) == sorted(manifest["leaves"])
    assert len(read_leaves(str(out / "port_ckpt"), 1)) == len(keys)


def test_missing_host_file_is_refused(tmp_path):
    st = {"a": torch.ones(3), "b": torch.zeros(2), "c": torch.arange(4)}
    save_state(st, str(tmp_path), 1, host_id=1, n_hosts=2)
    save_state(st, str(tmp_path), 1, host_id=0, n_hosts=2)
    back = restore_state(st, str(tmp_path), 1)
    assert all(torch.equal(back[k], st[k]) for k in st)
    (tmp_path / "step_000001" / "host_001.npz").unlink()
    with pytest.raises(FileNotFoundError, match="no host file holds"):
        restore_state(st, str(tmp_path), 1)


def test_host_share_copies_only_its_leaves():
    from repro_torch.checkpoint.store import _host_share
    st = {"a": torch.ones(3), "b": torch.zeros(2, dtype=torch.bfloat16),
          "c": torch.arange(4)}
    arrays, meta = _host_share(st, 1, 2)
    assert sorted(arrays) == ["b"]
    assert meta == {"a": {"shape": [3], "dtype": "float32"},
                    "b": {"shape": [2], "dtype": "bfloat16"},
                    "c": {"shape": [4], "dtype": "int64"}}
