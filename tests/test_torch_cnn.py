"""The port's whole slice against the JAX package: AlexNet at the SMOKE
size, and a narrow bottleneck net through both packages' kernels.

``cnn_forward`` on the port (CPU tensors) with the reference's params, taken
through ``params_from_reference``, for the methods ``dense``, ``lowered``,
``csr-direct``, ``pallas`` and ``bsr``, against the reference's ``dense``
at rtol = atol = 1e-4 (the tolerance the reference's serving smoke holds
``auto`` to ``dense`` with, ``launch/serve.py``: every method sums in another
order).  GoogLeNet and ResNet-50 have files of their own
(``test_torch_cnn_googlenet.py``, ``test_torch_cnn_resnet50.py``) so that
the three run in parallel.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine import spec as ref_spec  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.engine import params_from_reference  # noqa: E402
from repro_torch.engine import spec as port_spec  # noqa: E402
from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel  # noqa: E402
from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

IMAGE = 67  # the AlexNet SMOKE size of tests/test_engine.py
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


def to_numpy_params(params):
    """The reference's params as numpy: ``{"w", "b"}`` per conv plus
    ``_fc_rng``."""
    return {name: (int(entry) if name == "_fc_rng" else
                   {"w": np.asarray(entry["w"]), "b": np.asarray(entry["b"])})
            for name, entry in params.items()}


@functools.lru_cache(maxsize=None)
def reference_run():
    """(reference params, port params, input, reference dense logits)."""
    net = ref_cnn.alexnet()
    params = ref_cnn.init_cnn(net, 3, np.random.default_rng(0), IMAGE)
    x = (np.random.default_rng(1)
         .standard_normal((BATCH, 3, IMAGE, IMAGE)).astype(np.float32))
    want = np.asarray(ref_cnn.cnn_forward(net, params, jnp.asarray(x),
                                          "dense"))
    return (params, params_from_reference(to_numpy_params(params),
                                          device="cpu"), x, want)


@pytest.mark.parametrize("method", PORT_METHODS)
def test_alexnet_matches_reference_dense(method):
    _, params, x, want = reference_run()
    launches = (sparse_conv_kernel.launches, bsr_conv_kernel.launches)
    got = cnn.cnn_forward(cnn.alexnet(), params, x, method, device="cpu")
    # CPU tensors run the plain versions: no kernel count moves
    assert (sparse_conv_kernel.launches, bsr_conv_kernel.launches) == launches
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_alexnet_init_matches_reference():
    """Same generator, same draws, same pruning: the port's params equal the
    reference's bit for bit, ELL banks and FC weights included."""
    ref_params, _, _, _ = reference_run()
    params = cnn.init_cnn(cnn.alexnet(), 3, np.random.default_rng(0), IMAGE,
                          device="cpu")
    assert set(params) == set(ref_params)
    assert params["_fc_rng"] == int(ref_params["_fc_rng"])
    for name, entry in params.items():
        if name == "_fc_rng":
            continue
        ref = ref_params[name]
        assert set(entry) == set(ref), name
        np.testing.assert_array_equal(entry["w"].numpy(), np.asarray(ref["w"]))
        np.testing.assert_array_equal(entry["b"].numpy(), np.asarray(ref["b"]))
        if "ell" in entry:
            for f in ("value", "cidx", "ridx", "sidx", "nnz"):
                np.testing.assert_array_equal(
                    getattr(entry["ell"], f).numpy(),
                    np.asarray(getattr(ref["ell"], f)))
            np.testing.assert_array_equal(entry["ell2d"].colidx.numpy(),
                                          np.asarray(ref["ell2d"].colidx))
    ref_eng = ref_cnn.engine_for(ref_cnn.alexnet(), ref_params,
                                 (3, IMAGE, IMAGE))
    eng = cnn.engine_for(cnn.alexnet(), params, (3, IMAGE, IMAGE),
                         device="cpu")
    assert set(eng.fc_weights) == set(ref_eng.fc_weights)
    for key, w in eng.fc_weights.items():
        np.testing.assert_array_equal(w.numpy(), ref_eng.fc_weights[key])


def _bottleneck_net(S):
    """Conv stem and one projecting bottleneck: a sparse stride-2 1x1a, a
    sparse 3x3, and a sparse 1x1b tail that fuses bias + shortcut + ReLU."""
    body = (S.Conv("b/1x1a", 8, 1, 2, 0, sparsity=0.6), S.Relu(),
            S.Conv("b/3x3", 8, 3, 1, 1, sparsity=0.6), S.Relu(),
            S.Conv("b/1x1b", 16, 1, sparsity=0.6))
    return [S.Conv("conv1", 8, 3, 1, 1, sparsity=0.0), S.Relu(),
            S.Residual(body=body,
                       proj=S.Conv("b/proj", 16, 1, 2, 0, sparsity=0.0)),
            S.Relu(), S.Pool("gap"), S.FC("fc", 10)]


@pytest.mark.parametrize("method", ["pallas", "bsr"])
def test_bottleneck_net_matches_reference_kernels(method):
    """The reference's Pallas kernels (interpret mode) against the port's
    kernel methods; both sum each conv in f32, so 1e-5."""
    ref_net = _bottleneck_net(ref_spec)
    params = ref_cnn.init_cnn(ref_net, 3, np.random.default_rng(5), 10)
    x = np.random.default_rng(6).standard_normal((2, 3, 10, 10)).astype(
        np.float32)
    want = np.asarray(ref_cnn.cnn_forward(ref_net, params, jnp.asarray(x),
                                          method))
    port_params = params_from_reference(to_numpy_params(params),
                                        device="cpu")
    got = cnn.cnn_forward(_bottleneck_net(port_spec), port_params, x, method,
                          device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_auto_and_unknown_methods_raise():
    """``auto`` runs (``test_torch_engine_auto.py`` holds it to the
    reference's); it raises where its plan pins a tile the card's kernel
    does not take, naming the layer, and an unknown method raises."""
    from repro_torch.tuning import PlanEntry
    _, params, x, _ = reference_run()
    plan = {"conv2": PlanEntry(method="pallas", tm=4, pad_to=8)}
    with pytest.raises(ValueError, match="conv2.*unsupported_tm"):
        cnn.cnn_forward(cnn.alexnet(), params, x, "auto", plan=plan,
                        device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        cnn.cnn_forward(cnn.alexnet(), params, x, "nope", device="cpu")
