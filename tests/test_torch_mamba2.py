"""The port's Mamba2 block against the JAX package's: the chunked SSD scan
(``ssd_scan`` against ``_ssd_scan``), the block's prefill and the state it
ends in, and the one-step decode recurrence, on f32 inputs from numpy and
the reference's ``init_mamba2`` params.

The scan is held to rtol = atol = 1e-5 (f32; the same products summed in
another order), at T = 32 (four chunks of 8), T = 8 (one) and T = 5
(shorter than the chunk: one chunk of T), from a zero and a given state.
Both packages refuse a T that the chunk does not divide (the reference
asserts it).  Blocks and states to rtol = atol = 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 8


def _scan_inputs(b, t, nh, hd, ns, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, nh, hd)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, t, nh)))).astype(
                np.float32),                                  # dt > 0
            np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32),
            rng.standard_normal((b, t, ns)).astype(np.float32),
            rng.standard_normal((b, t, ns)).astype(np.float32),
            rng.standard_normal((b, nh, ns, hd)).astype(np.float32))


@pytest.mark.parametrize("t", [32, 8, 5])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_reference(t, with_state):
    xh, dt, a_log, bm, cm, h0 = _scan_inputs(2, t, 4, 16, 8, seed=t)
    init = h0 if with_state else None
    want_y, want_h = RL._ssd_scan(
        *(jnp.asarray(a) for a in (xh, dt, a_log, bm, cm)), CHUNK,
        init_state=None if init is None else jnp.asarray(init))
    got_y, got_h = L.ssd_scan(
        *(torch.from_numpy(a) for a in (xh, dt, a_log, bm, cm)), CHUNK,
        init_state=None if init is None else torch.from_numpy(init))
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def test_ssd_scan_refuses_a_ragged_chunk_as_the_reference_does():
    xh, dt, a_log, bm, cm, _ = _scan_inputs(1, 12, 2, 16, 8, seed=0)
    with pytest.raises(AssertionError):
        RL._ssd_scan(*(jnp.asarray(a) for a in (xh, dt, a_log, bm, cm)),
                     CHUNK)
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        L.ssd_scan(*(torch.from_numpy(a) for a in (xh, dt, a_log, bm, cm)),
                   CHUNK)


def _block():
    ref_cfg = dataclasses.replace(ref_configs.get_config("mamba2-2.7b",
                                                         smoke=True),
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get_config("mamba2-2.7b", smoke=True),
                              dtype="float32")
    ref_p = RL.init_mamba2(jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    return ref_cfg, cfg, ref_p, p


@pytest.mark.parametrize("t", [16, 2])
def test_block_prefill_and_its_state_match_reference(t):
    """The block over T positions and the state it ends in (SSM state and
    conv tail); below w - 1 positions both return no state."""
    ref_cfg, cfg, ref_p, p = _block()
    x = np.random.default_rng(t).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    want, want_state = RL.mamba2_fwd(ref_p, jnp.asarray(x), ref_cfg)
    got, state = L.mamba2_fwd(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if t < cfg.ssm_conv_width - 1:
        assert want_state is None and state is None
        return
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(want_state[name]), **TOL)


def test_block_decode_steps_the_state_in_place():
    """Eight one-token steps from a prefill's state: each step's output and
    new state match the reference's; the port updates the state tensors in
    place and returns them."""
    ref_cfg, cfg, ref_p, p = _block()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    _, ref_state = RL.mamba2_fwd(ref_p, jnp.asarray(x), ref_cfg)
    _, state = L.mamba2_fwd(p, torch.from_numpy(x), cfg)
    ssm, conv = state["ssm"], state["conv"]
    for i in range(8):
        xi = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, ref_state = RL.mamba2_fwd(ref_p, jnp.asarray(xi), ref_cfg,
                                        state=ref_state)
        got, state = L.mamba2_fwd(p, torch.from_numpy(xi), cfg, state=state)
        assert state["ssm"] is ssm and state["conv"] is conv
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(state[name].numpy(),
                                       np.asarray(ref_state[name]), **TOL)


def test_init_mamba2_keeps_the_reference_dtypes():
    """In a bf16 model, a_log, d_skip and dt_bias are f32 and the rest
    bf16, with the reference's shapes; a_log is log(linspace(1, 16))."""
    ref_cfg = ref_configs.get_config("mamba2-2.7b", smoke=True)
    cfg = configs.get_config("mamba2-2.7b", smoke=True)
    ref_p = RL.init_mamba2(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    p = L.init_mamba2(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      "cpu")
    assert sorted(p) == sorted(ref_p)
    for name, leaf in p.items():
        assert tuple(leaf.shape) == ref_p[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == str(ref_p[name].dtype), name
    np.testing.assert_allclose(p["a_log"].numpy(), np.asarray(ref_p["a_log"]),
                               rtol=1e-6)
    state = L.init_mamba2_state(cfg, 3, torch.bfloat16, "cpu")
    ref_state = RL.init_mamba2_state(ref_cfg, 3, jnp.bfloat16)
    for name in ("ssm", "conv"):
        assert tuple(state[name].shape) == ref_state[name].shape
        assert str(state[name].dtype).split(".")[-1] == \
            str(ref_state[name].dtype)
