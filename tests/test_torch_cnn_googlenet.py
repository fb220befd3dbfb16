"""The port's whole slice against the JAX package on GoogLeNet at the SMOKE
size (48 px), full width: every port method with the reference's params
(through ``params_from_reference``) against the reference's ``dense`` at
rtol = atol = 1e-4, and its ELL banks against the reference's builder.  All
49 sparse layers (1x1, 3x3 and 5x5 branches of the inception modules) run
through each method."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.engine import params_from_reference  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

IMAGE = 48  # the GoogLeNet SMOKE size of tests/test_engine.py
BATCH = 2
PORT_METHODS = ("dense", "lowered", "csr-direct", "pallas", "bsr")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def reference_run():
    """(numpy params, port params, input, reference dense logits).

    The weights come from the port's ``init_cnn`` on the CPU, which draws and
    prunes exactly as the reference's does (``test_torch_cnn.py`` holds the
    two inits to bit-identity); the reference's own init would spend most of
    this file's time compiling one quantile per layer shape.  The reference
    runs ``dense`` on them, and the port takes them back through
    ``params_from_reference``.
    """
    params = cnn.init_cnn(cnn.googlenet(), 3, np.random.default_rng(0), IMAGE,
                          device="cpu")
    np_params = {name: (int(entry) if name == "_fc_rng" else
                        {"w": entry["w"].numpy(), "b": entry["b"].numpy()})
                 for name, entry in params.items()}
    ref_params = {name: (entry if name == "_fc_rng" else
                         {"w": jnp.asarray(entry["w"]),
                          "b": jnp.asarray(entry["b"])})
                  for name, entry in np_params.items()}
    x = (np.random.default_rng(1)
         .standard_normal((BATCH, 3, IMAGE, IMAGE)).astype(np.float32))
    want = np.asarray(ref_cnn.cnn_forward(ref_cnn.googlenet(), ref_params,
                                          jnp.asarray(x), "dense"))
    return np_params, params_from_reference(np_params, device="cpu"), x, want


@pytest.mark.parametrize("method", PORT_METHODS)
def test_googlenet_matches_reference_dense(method):
    _, params, x, want = reference_run()
    got = cnn.cnn_forward(cnn.googlenet(), params, x, method, device="cpu")
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_googlenet_banks_match_reference_builders():
    """Every one of the 49 pruned layers gets an ELL bank from
    ``params_from_reference`` that is bit-identical to the reference's
    ``ell_from_dense_conv`` on the same weights, at full width."""
    from repro.core.sparse_format import ell_from_dense_conv
    np_params, params, _, _ = reference_run()
    sparse = [n for n, e in params.items() if n != "_fc_rng" and "ell" in e]
    assert len(sparse) == 49
    for name in sparse:
        want = ell_from_dense_conv(np_params[name]["w"])
        for f in ("value", "cidx", "ridx", "sidx", "nnz"):
            np.testing.assert_array_equal(
                getattr(params[name]["ell"], f).numpy(),
                np.asarray(getattr(want, f)), err_msg=f"{name}.{f}")
