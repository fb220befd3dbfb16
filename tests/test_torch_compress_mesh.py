"""The meshed train step's int8 cross-pod all-reduce (``compress_cross_pod``)
held leaf by leaf.

In a spawned 4-rank gloo world (``tests/_torch_mesh.py``), qwen1.5-0.5b's
f32 smoke config on (2, 2, 1) ("pod", "data", "model": leaves sharded
over "data", one scale per whole leaf) and on (2, 1, 1) (whole leaves):

* every compressed gradient leaf lies within the int8 bound of the
  uncompressed all-reduced one.  Pod p's mean gradient x_p is quantised
  with scale s_p = max|x_p| / 127 and the int8 sum dequantised with the
  pods' mean scale s, so |got - want| <= (1/n) sum_p (s_p / 2 +
  127 |s - s_p|) an element, plus f32 rounding.  A step that left the
  exchange out (each pod on its own mean) or scaled it by the pod count
  lies far outside;
* the reference's ``compressed_psum_tree``, fed the same per-pod means,
  gives the port's compressed gradient within 1e-6;
* the step's grad_norm is the compressed gradient's, within the bound of
  the uncompressed one's, and the first step's moments are built from the
  compressed gradient;
* after 3 compressed steps every leaf of the state is bit-equal across
  the pods.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh as M  # noqa: E402

MESHES = ["pod2x2x1", "pod2x1x1"]
B1, CLIP = 0.9, 1.0      # AdamWConfig's defaults, as the step runs them


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_compress_step")
    np.savez(out / "batch_512.npz", **M.batch(512))
    M.spawn_world(M.rank_compress_step, 4, str(out))
    M.run_reference(M.REF_COMPRESS, out,
                    [[f"{m}.pods", f"{m}.ref"] for m in MESHES])
    return out


def _load(runs, mesh):
    port = dict(np.load(runs / f"{mesh}.port.npz"))
    ref = dict(np.load(runs / f"{mesh}.ref.npz"))
    return port, ref, [str(k) for k in port["keys"]]


def _bounds(port, keys):
    """Per leaf, the int8 bound an element (f32 rounding included)."""
    s = port["pod_scales"].astype(np.float64)          # (n_pod, leaves)
    n = s.shape[0]
    mean = s.mean(0)
    out = {}
    for i, k in enumerate(keys):
        q = sum(s[p, i] / 2 + 127 * abs(mean[i] - s[p, i])
                for p in range(n)) / n
        out[k] = q + 1e-6 * float(np.abs(port[f"pods:{k}"]).max())
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_compressed_gradient_within_int8_bound(runs, mesh):
    port, _, keys = _load(runs, mesh)
    bounds = _bounds(port, keys)
    for k in keys:
        err = np.abs(port[f"gc:{k}"].astype(np.float64) - port[f"g:{k}"])
        assert err.max() <= bounds[k], (k, float(err.max()), bounds[k])
    # the pods' means differ by more than the bound somewhere: the check
    # can tell a step without the exchange from one with it
    assert any(np.abs(port[f"pods:{k}"][0] - port[f"pods:{k}"][1]).max()
               > 4 * bounds[k] for k in keys)


@pytest.mark.parametrize("mesh", MESHES)
def test_compressed_gradient_matches_reference(runs, mesh):
    port, ref, keys = _load(runs, mesh)
    for k in keys:
        want = ref[k]
        np.testing.assert_allclose(
            port[f"gc:{k}"], want, rtol=0,
            atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_step_norm_and_moments_are_the_compressed_gradient_s(runs, mesh):
    port, _, keys = _load(runs, mesh)
    bounds = _bounds(port, keys)
    gc = np.sqrt(sum(np.sum(np.square(port[f"gc:{k}"].astype(np.float64)))
                     for k in keys))
    g = np.sqrt(sum(np.sum(np.square(port[f"g:{k}"].astype(np.float64)))
                    for k in keys))
    slack = np.sqrt(sum(port[f"g:{k}"].size * bounds[k] ** 2 for k in keys))
    assert abs(port["gnorm_c"] - gc) <= 1e-5 * gc
    assert abs(port["step_gnorm"] - port["gnorm_c"]) <= 1e-6 * gc
    assert abs(gc - g) <= slack, (gc, g, slack)
    scale = min(1.0, CLIP / port["step_gnorm"])
    for k in keys:
        want = (1 - B1) * port[f"gc:{k}"].astype(np.float64) * scale
        np.testing.assert_allclose(
            port[f"m1:{k}"], want, rtol=0,
            atol=1e-6 * max(1e-6, float(np.abs(want).max())), err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_state_equal_across_pods_after_steps(runs, mesh):
    port, _, _ = _load(runs, mesh)
    assert bool(port["pods_equal"])
