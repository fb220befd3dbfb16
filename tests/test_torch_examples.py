"""The port's two root examples, run on the CPU at a small size.

``repro_torch.examples.quickstart`` (``examples/quickstart.py``): one conv
layer pruned to 0.85 and run ``dense``, ``lowered``, ``csr-direct`` and
through the ELL kernel (its plain version here), and a (512, 256) linear
layer block-pruned into (64, 64) tiles, through the BCSR matmul kernel (its
plain version here) and dense.  The reference's script prints each
method's max |err| against its own ``dense``; here every output of the
port's script is held to the reference's ``dense_conv`` / ``dense_matmul``
on the same draws (pruned by the reference's ``magnitude_prune`` /
``block_prune``) within 1e-4 x max(1, max |dense|), the CNN methods'
agreement rule.

``repro_torch.examples.train_then_prune`` (``examples/train_then_prune.py``)
at ``--smoke``: 6 train steps, pruning to 0.7 and 16 served tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (block_prune as ref_block_prune,  # noqa: E402
                        dense_conv as ref_dense_conv,
                        dense_matmul as ref_dense_matmul,
                        magnitude_prune as ref_magnitude_prune)
from repro_torch.examples import quickstart, train_then_prune  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quickstart_methods_agree(capsys):
    outs = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "quickstart OK" in out and "8/32 tiles survive" in out
    # the reference's draws, in its script's order, and its dense layers
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, 16, 28, 28)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((32, 16, 3, 3)).astype(np.float32))
    conv = np.asarray(ref_dense_conv(x, ref_magnitude_prune(w, 0.85),
                                     padding=1))
    xl = jnp.asarray(rng.standard_normal((8, 256)).astype(np.float32))
    wl = jnp.asarray(rng.standard_normal((512, 256)).astype(np.float32))
    linear = np.asarray(ref_dense_matmul(
        xl, ref_block_prune(wl, 0.75, (64, 64))))
    assert sorted(outs) == sorted(
        ["dense  (cuDNN)", "lowered (cuSPARSE analogue)",
         "escoin direct (PyTorch)", "escoin direct (kernel)",
         "dense linear", "bcsr linear"])
    for name, got in outs.items():
        want = linear if "linear" in name else conv
        limit = 1e-4 * max(1.0, float(np.abs(want).max()))
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        err = float(np.abs(got.numpy() - want).max())
        assert err <= limit, (name, err, limit)


def test_train_then_prune_runs(capsys):
    last = train_then_prune.main(["--smoke", "--steps", "6", "--batch", "2",
                                  "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert np.isfinite(last)
    assert "trained 6 steps" in out
    assert "pruned to sparsity 0.7 and served 16 tokens" in out
