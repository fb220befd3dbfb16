"""The port's engine against the JAX package's: lowering, binding, devices.

``lower`` is a pure-Python copy, so the port's program must equal the
reference's op for op; the engine's entry points must run on the card unless
the caller asks for the CPU, and raise without one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import lower as ref_lower  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.engine import (METHODS, CnnEngine, lower,  # noqa: E402
                                params_from_reference)
from repro_torch.engine.engine import _pool  # noqa: E402
from repro_torch.engine.program import PoolOp  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

NETS = [("alexnet", 67), ("googlenet", 48), ("resnet50", 48),
        ("alexnet", 224), ("googlenet", 224), ("resnet50", 224)]


def _fields(op):
    return (type(op).__name__,
            tuple(v for k, v in dataclasses.asdict(op).items()))


@pytest.mark.parametrize("net_name, image", NETS)
def test_program_matches_reference(net_name, image):
    ref = ref_lower(ref_cnn.NETWORKS[net_name](), (3, image, image))
    got = lower(cnn.NETWORKS[net_name](), (3, image, image))
    assert [_fields(op) for op in got.ops] == [_fields(op) for op in ref.ops]
    assert got.out == ref.out and got.in_shape == ref.in_shape
    assert ([(dataclasses.asdict(l), shape) for l, shape in got.conv_table]
            == [(dataclasses.asdict(l), shape) for l, shape in ref.conv_table])
    assert got.summary() == ref.summary()


def test_methods_kept_verbatim():
    from repro.engine import METHODS as REF_METHODS
    assert METHODS == REF_METHODS


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = cnn.alexnet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn.init_cnn(net, 3, np.random.default_rng(0), 67)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    program = lower(net, (3, 67, 67))
    params = {"_fc_rng": 0}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CnnEngine(program, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(params)
    assert resolve_device("cpu") == torch.device("cpu")


def test_params_from_reference_rebuilds_banks_for_pruned_layers():
    w_dense = np.random.default_rng(0).standard_normal((8, 4, 3, 3)).astype(
        np.float32)
    w_sparse = w_dense * (np.abs(w_dense) > 1.0)
    params = params_from_reference(
        {"a": {"w": w_dense, "b": np.zeros(8, np.float32)},
         "b": {"w": w_sparse, "b": np.ones(8, np.float32)},
         "_fc_rng": np.int64(7)}, device="cpu")
    assert set(params["a"]) == {"w", "b"}
    assert set(params["b"]) == {"w", "b", "ell", "ell2d"}
    assert params["_fc_rng"] == 7
    assert int(params["b"]["ell"].nnz.sum()) == int((w_sparse != 0).sum())


@pytest.mark.parametrize("kind, k, stride, pad", [
    ("max", 3, 2, 0), ("max", 3, 2, 1), ("max", 3, 1, 1), ("avg", 3, 2, 1),
    ("gap", 3, 2, 0)])
def test_pool_matches_reference(kind, k, stride, pad):
    import jax.numpy as jnp
    from repro.engine.engine import _pool as ref_pool
    from repro.engine.program import PoolOp as RefPoolOp
    x = np.random.default_rng(1).standard_normal((2, 3, 9, 9)).astype(np.float32)
    got = _pool(PoolOp(kind, k, stride, pad, 0, 1, 0, 0), torch.from_numpy(x))
    want = ref_pool(RefPoolOp(kind, k, stride, pad, 0, 1, 0, 0),
                    jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_engine_caches_bcsr_banks_and_engines():
    net = cnn.alexnet()
    params = cnn.init_cnn(net, 3, np.random.default_rng(0), 67, device="cpu")
    eng = cnn.engine_for(net, params, (3, 67, 67), device="cpu")
    assert cnn.engine_for(net, params, (3, 67, 67), device="cpu") is eng
    op = next(o for o in eng.program.conv_ops if o.sparsity > 0)
    bank = eng._bcsr_for(op, params[op.name])
    assert eng._bcsr_for(op, params[op.name]) is bank
    assert bank.block == (8, 128)
    # replacing a parameter leaf binds a fresh engine
    params[op.name] = dict(params[op.name], b=params[op.name]["b"] + 1)
    assert cnn.engine_for(net, params, (3, 67, 67), device="cpu") is not eng


def test_engine_packs_ell_indices_once():
    from repro_torch.kernels.sparse_conv.ops import pack_indices
    net = cnn.alexnet()
    params = cnn.init_cnn(net, 3, np.random.default_rng(0), 67, device="cpu")
    eng = CnnEngine(lower(net, (3, 67, 67)), params, device="cpu")
    x = np.random.default_rng(1).standard_normal((1, 3, 67, 67)).astype(
        np.float32)
    y = eng(x, "pallas")
    sparse = [op.name for op in eng.program.conv_ops if op.sparsity > 0]
    # keyed on (layer, balanced, value dtype), each beside its bank
    assert sorted(eng._packed_cache) == [(n, False, "float32")
                                         for n in sorted(sparse)]
    packed = {k[0]: v[1] for k, v in eng._packed_cache.items()}
    for name in sparse:
        assert torch.equal(packed[name], pack_indices(params[name]["ell"]))
    torch.testing.assert_close(eng(x, "pallas"), y, rtol=0, atol=0)
    assert all(v[1] is packed[k[0]] for k, v in eng._packed_cache.items())
