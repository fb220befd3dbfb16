"""The port's expert-parallel MoE (``models/moe_ep.py``) against the
reference's, in the meshed train step.

olmoe-1b-7b's f32 smoke config (8 experts, top 2) on a (2, 2) ("data",
"model") mesh under ``MOE_IMPL = "ep"``: each model rank owns 4 experts,
its tokens are its batch shard and sequence half, and the two all-to-alls
move them.  The reference (``tests/_torch_mesh.py``) counts what its
``_bucket_by`` drops on every device through ``jax.debug.callback``; the
port counts the same with ``moe_ep.count_drops``.  At capacity factors
1.25 (the default) and 0.5 (most assignments over capacity at one level or
the other) the 3 steps' loss and grad_norm agree within 1e-4 relative and
the drop totals are equal and non-zero.

Port-only: ``_bucket_by``'s slots, inverse and drops on hand-made inputs,
the sentinel bucket of a received buffer included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh as M  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402

CAPACITIES = {"ep_cf125": 1.25, "ep_cf050": 0.5}


def _cases():
    return [dict(name=n, arch="olmoe-1b-7b", shape=[2, 2],
                 axes=["data", "model"], moe_impl="ep", attn="chunked",
                 capacity=cf) for n, cf in CAPACITIES.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ep")
    np.savez(out / "batch_512.npz", **M.batch(512))
    M.run_reference(M.REF_TRAIN, out, _cases())
    M.spawn_world(M.rank_train, 4, _cases(), str(out))
    return out


@pytest.mark.parametrize("metric", ["loss", "gnorm"])
@pytest.mark.parametrize("name", list(CAPACITIES))
def test_ep_step_matches_reference(runs, name, metric):
    want = np.load(runs / f"{name}.npz")[metric]
    got = np.load(runs / f"{name}.port.npz")[metric]
    for i in range(M.STEPS):
        M.close(float(got[i]), float(want[i]), f"{name} step {i + 1} {metric}")


@pytest.mark.parametrize("name", list(CAPACITIES))
def test_ep_drops_match_reference(runs, name):
    want = int(np.load(runs / f"{name}.npz")["drops"])
    got = int(np.load(runs / f"{name}.port.npz")["drops"])
    assert got == want and want > 0, (got, want)


def test_bucket_by_slots_and_drops():
    dest = torch.tensor([1, 0, 1, 1, 2, 0, 1])
    with moe_ep.count_drops() as drops:
        slot, tok = moe_ep._bucket_by(dest, 3, 2)
    # bucket 1 holds items 0, 2; item 3 and 6 overflow to slot >= 6
    assert slot.tolist()[:3] == [2, 0, 3]
    assert slot[3] >= 6 and slot[6] >= 6
    assert tok.tolist() == [1, 5, 0, 2, 4, 7]
    assert drops == [2]


def test_bucket_by_sentinel_bucket_is_not_a_drop():
    # ids past the last bucket (a received buffer's empty slots) fill no
    # slot and count as no drop
    dest = torch.tensor([2, 0, 2, 2, 1])
    with moe_ep.count_drops() as drops:
        slot, tok = moe_ep._bucket_by(dest, 2, 1)
    assert tok.tolist() == [1, 4]
    assert slot[1] == 0 and slot[4] == 1
    assert all(int(slot[i]) >= 2 for i in (0, 2, 3))
    assert drops == [0]
