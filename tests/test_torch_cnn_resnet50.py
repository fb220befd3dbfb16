"""The port's whole slice against the JAX package on ResNet-50 at the SMOKE
size (48 px), full width: every port method, with the params taken through
``params_from_reference``, against the reference's ``dense`` at
rtol = atol = 1e-4.  All 39 sparse
layers, the 13 fused residual tails and the stride-2 sparse ``1x1a`` layers
run through each method."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.engine import params_from_reference  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

IMAGE = 48  # the SMOKE size of tests/test_engine.py
BATCH = 2
PORT_METHODS = ("dense", "lowered", "csr-direct", "pallas", "bsr")
# The tolerance the reference's serving smoke holds ``auto`` to ``dense``
# with (launch/serve.py): every method sums in another order.
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
    params = cnn.init_cnn(cnn.resnet50(), 3, np.random.default_rng(0), IMAGE,
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
    want = np.asarray(ref_cnn.cnn_forward(ref_cnn.resnet50(), ref_params,
                                          jnp.asarray(x), "dense"))
    return np_params, params_from_reference(np_params, device="cpu"), x, want


@pytest.mark.parametrize("method", PORT_METHODS)
def test_resnet50_matches_reference_dense(method):
    _, params, x, want = reference_run()
    got = cnn.cnn_forward(cnn.NETWORKS["resnet50"](), params, x, method,
                          device="cpu")
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_resnet50_program_shape():
    program = cnn._lowered(cnn.NETWORKS["resnet50"](), 3, IMAGE, IMAGE)
    sparse = [op for op in program.conv_ops if op.sparsity > 0]
    assert len(sparse) == 39
    assert sum(op.res is not None for op in sparse) == 13
    assert sum(op.stride == 2 and op.k == 1 for op in sparse) == 3
