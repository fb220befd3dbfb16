"""The port's meshed train step against the reference's meshed step.

The reference (``tests/_torch_mesh.py``: a subprocess with 4 forced host
devices, meshes from ``repro.runtime.build_mesh``) saves its initial train
state from the mesh with its own ``save_state`` and takes 3 jitted steps;
the port restores that checkpoint into a spawned 4-rank gloo world, places
it by ``state_placements`` on the same mesh shape and takes 3
``make_train_step`` steps on the same seeded batch.  Loss and grad_norm
agree within 1e-4 relative at every step (f32 smoke configs):

* qwen1.5-0.5b on (2, 2), chunked and flash (tensor-parallel mode A: whole
  kv groups a rank), and olmoe-1b-7b's gather MoE on (2, 2), also under
  both packages' ``MOE_CONSTRAIN`` (a layout hint in the reference that
  the port's explicit layout always follows);
* yi-9b on (1, 4) under flash: 4 heads, 2 kv heads, one q head a rank,
  mode B (each rank's single kv head cut from the gathered wk / wv);
* qwen1.5-4b on (2, 2) under flash: 5 heads on tp 2 (h % tp != 0), the
  chunked attention replicated over the model dim, as the reference falls
  back.

``compressed_psum_tree`` over the "pod" dim of a (2, 2, 1) mesh holds the
reference's within 1e-6.  The expert-parallel MoE is
``test_torch_moe_ep.py``, the elastic restore ``test_torch_elastic.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh as M  # noqa: E402

AXES = ["data", "model"]
CASES = {
    "qwen_chunked_2x2": ("qwen1.5-0.5b", [2, 2], "chunked"),
    "qwen_flash_2x2": ("qwen1.5-0.5b", [2, 2], "flash"),
    "olmoe_gather_2x2": ("olmoe-1b-7b", [2, 2], "chunked"),
    "olmoe_constrain_2x2": ("olmoe-1b-7b", [2, 2], "chunked"),
    "yi_flash_mode_b_1x4": ("yi-9b", [1, 4], "flash"),
    "qwen4b_flash_h5_2x2": ("qwen1.5-4b", [2, 2], "flash"),
}


def _cases():
    return [dict(name=n, arch=a, shape=s, axes=AXES, moe_impl="gather",
                 attn=at, capacity=1.25, constrain="constrain" in n)
            for n, (a, s, at) in CASES.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    np.savez(out / "batch_512.npz", **M.batch(512))
    M.run_reference(M.REF_TRAIN, out, _cases())
    M.spawn_world(M.rank_train, 4, _cases(), str(out))
    return out


@pytest.mark.parametrize("metric", ["loss", "gnorm"])
@pytest.mark.parametrize("name", list(CASES))
def test_meshed_step_matches_reference(runs, name, metric):
    want = np.load(runs / f"{name}.npz")[metric]
    got = np.load(runs / f"{name}.port.npz")[metric]
    assert len(got) == len(want) == M.STEPS
    for i in range(M.STEPS):
        M.close(float(got[i]), float(want[i]), f"{name} step {i + 1} {metric}")


def test_meshed_loss_falls(runs):
    for name in CASES:
        loss = np.load(runs / f"{name}.port.npz")["loss"]
        assert np.all(np.isfinite(loss)) and loss[-1] < loss[0], (name, loss)


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_compress")
    rs = np.random.RandomState(3)
    np.savez(out / "pods.npz",
             a=rs.randn(2, 37, 5).astype(np.float32),
             b=(rs.randn(2, 64) * np.array([[1e-3], [10.0]])).astype(
                 np.float32),
             c=np.zeros((2, 8), np.float32))
    M.run_reference(M.REF_COMPRESS, out, [])
    M.spawn_world(M.rank_compress, 4, str(out))
    return out


@pytest.mark.parametrize("leaf", ["a", "b", "c"])
def test_compressed_psum_matches_reference(compressed, leaf):
    want = np.load(compressed / "compressed.npz")[leaf]
    got = np.load(compressed / "compressed.port.npz")[leaf]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(
        1.0, float(np.abs(want).max())))
