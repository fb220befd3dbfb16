"""The port's meshed train step on the non-dense families, against the
reference's meshed step.

As ``test_torch_distributed.py`` (``tests/_torch_mesh.py``: the reference
in a subprocess with 4 forced host devices, meshes from
``repro.runtime.build_mesh``, its initial state saved from the mesh with
its own ``save_state``; the port in a spawned 4-rank gloo world restoring
that checkpoint), on a (2, 2) ("data", "model") mesh, 3 steps, loss and
grad_norm within 1e-4 relative at every step (f32 smoke configs):

* deepseek-v3-671b: MLA mixers (weights gathered whole over the model dim,
  each rank keeping its sequence slice), the MoE, and the MTP loss term on
  the meshed hidden states;
* jamba-1.5-large-398b: Mamba2 mixers (replicated over the model dim as
  MLA), GQA attention and the MoE interleaved;
* phi-3-vision-4.2b: a VLM trained on f32 embeddings (the pipeline's
  input for that family) placed on the mesh, no token lookup.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh as M  # noqa: E402

AXES = ["data", "model"]
CASES = {
    "deepseek_mla_mtp_2x2": ("deepseek-v3-671b", None),
    "jamba_mamba2_2x2": ("jamba-1.5-large-398b", None),
    "phi3v_embeds_2x2": ("phi-3-vision-4.2b", "embeds_64"),
}


def _cases():
    return [dict(name=n, arch=a, shape=[2, 2], axes=AXES,
                 moe_impl="gather", attn="chunked", capacity=1.25,
                 batch=b) for n, (a, b) in CASES.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_families")
    np.savez(out / "batch_512.npz", **M.batch(512))
    np.savez(out / "embeds_64.npz", **M.embeds_batch(64, 512))
    M.run_reference(M.REF_TRAIN, out, _cases())
    M.spawn_world(M.rank_train, 4, _cases(), str(out))
    return out


@pytest.mark.parametrize("metric", ["loss", "gnorm"])
@pytest.mark.parametrize("name", list(CASES))
def test_meshed_family_step_matches_reference(runs, name, metric):
    want = np.load(runs / f"{name}.npz")[metric]
    got = np.load(runs / f"{name}.port.npz")[metric]
    assert len(got) == len(want) == M.STEPS
    for i in range(M.STEPS):
        M.close(float(got[i]), float(want[i]), f"{name} step {i + 1} {metric}")


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_family_loss_falls(runs, name):
    loss = np.load(runs / f"{name}.port.npz")["loss"]
    assert np.all(np.isfinite(loss)) and loss[-1] < loss[0], (name, loss)
