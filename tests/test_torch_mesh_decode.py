"""The port's meshed decode (``steps.make_serve_step`` on placed params, a
placed cache and DTensor tokens) against the reference's jitted meshed
``decode_step``.

As ``test_torch_distributed.py`` (``tests/_torch_mesh.py``): the reference
in one subprocess with 4 forced host devices (meshes from
``repro.runtime.build_mesh``; ``in_shardings`` from ``param_specs`` and
``decode_input_specs``, the cache donated), saving its params and its last
cache with its own ``save_state``; the port in one spawned 4-rank gloo
world on those params.  f32 smoke configs, B 4 x a cache of 16, the tokens
teacher-forced for 16 steps (cur_len 0..15), so that a cache split by
sequence is written on every rank's slice.  Cases:

* yi-9b on (1, 4): its KV cache split by sequence (kv 2 on tp 4), every
  query head on every rank, the slices combined by log-sum-exp;
* yi-9b on (2, 2): its KV heads over tp;
* deepseek-v3-671b on (2, 2): the absorbed MLA decode over the latent
  cache split by sequence, its MoE;
* jamba-1.5-large-398b on (2, 2): Mamba2 with its SSM heads over tp, GQA
  attention and the MoE;
* olmoe-1b-7b on (2, 2) under ``MOE_IMPL = "ep"``;
* jamba-1.5-large-398b on (2, 2) at B 1: the batch dim dropped;
* yi-9b on (2, 2) sparse: each rank's tp shards pruned at 0.8 in the
  reference's (M / tp, 128) blocks and run as BCSR
  (``sparse_weights.sparsify_shards``); the reference decodes the same
  pruned weights dense.  Its smoke config is widened (``SPARSE_WIDTHS``:
  d_model 512, 8 heads of 128, 4 KV heads, d_ff 1024) so that every
  converted shard holds 4 or 8 of those tiles and keeps a quarter of them:
  at the smoke config's d_model 64 a shard is one or two tiles, and the
  0.8 rule zeroes a one-tile shard whole.

Each step's logits are held within 1e-4 x max(1, max |reference|) of the
reference's and within 1e-5 of that measure of the port's meshless decode
on the same params; every cache leaf after the last step, gathered whole,
within 1e-5 x max(1, max |reference leaf|); ``serve_step``'s next tokens
equal the reference's argmax wherever its top two logits differ by more
than the logits' tolerance.  The sparse case's BCSR shards, gathered whole
as dense weights, equal the pruned weights bit for bit.  The distributed
argmax returns the first maximal index on ties across ranks.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh as M  # noqa: E402

AXES = ["data", "model"]
B = 4
SPARSE_WIDTHS = dict(d_model=512, n_heads=8, n_kv_heads=4, head_dim=128,
                     d_ff=1024)
CASES = {
    "yi_seq_1x4": dict(arch="yi-9b", shape=[1, 4]),
    "yi_heads_2x2": dict(arch="yi-9b", shape=[2, 2]),
    "deepseek_mla_2x2": dict(arch="deepseek-v3-671b", shape=[2, 2]),
    "jamba_2x2": dict(arch="jamba-1.5-large-398b", shape=[2, 2]),
    "olmoe_ep_2x2": dict(arch="olmoe-1b-7b", shape=[2, 2], moe_impl="ep"),
    "jamba_b1_2x2": dict(arch="jamba-1.5-large-398b", shape=[2, 2],
                         batch=1),
    "yi_sparse_2x2": dict(arch="yi-9b", shape=[2, 2], sparsity=0.8,
                          min_dim=16, cfg=SPARSE_WIDTHS),
}
LOGITS_RTOL = 1e-4
MESHLESS_RTOL = 1e-5
CACHE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cases():
    return [dict(dict(name=n, axes=AXES, moe_impl="gather", capacity=1.25,
                      batch=B), **c) for n, c in CASES.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_decode")
    for b in {c["batch"] for c in _cases()}:
        np.save(out / f"tokens_{b}.npy", M.decode_tokens(512, b))
    M.run_reference(M.REF_DECODE, out, _cases())
    M.spawn_world(M.rank_decode, 4, _cases(), str(out))
    return out


def _case(name):
    return next(c for c in _cases() if c["name"] == name)


def _params(runs, name):
    from repro_torch.checkpoint import read_tree
    from repro_torch.models import transformer as T
    cfg = M._cfg(_case(name)["arch"], _case(name).get("cfg"))
    return cfg, T.params_from_reference(
        read_tree(str(runs / name / "params"), 0), cfg, "cpu")


@pytest.fixture(scope="module")
def meshless(runs):
    """Each case's logits from the port's meshless decode on the same
    params and tokens (the case's MoE flags set, then restored)."""
    from repro_torch.models import flags
    from repro_torch.models import transformer as T
    old = (flags.MOE_IMPL, flags.MOE_CAPACITY, flags.ATTN_IMPL)
    out = {}
    try:
        for c in _cases():
            M._flags(dict(c, attn="chunked"))
            cfg, params = _params(runs, c["name"])
            toks = torch.from_numpy(
                np.load(runs / f"tokens_{c['batch']}.npy"))
            cache = T.init_cache(cfg, c["batch"], M.DECODE_SEQ, "cpu")
            steps = []
            with torch.no_grad():
                for i in range(M.DECODE_SEQ):
                    lg, cache = T.decode_step(params, cfg, toks[:, i:i + 1],
                                              cache, i)
                    steps.append(lg.numpy())
            out[c["name"]] = np.stack(steps)
    finally:
        flags.set_moe_impl(old[0])
        flags.set_moe_capacity(old[1])
        flags.set_attn_impl(old[2])
    return out


def _tol(want, rtol):
    return rtol * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_decode_logits_match_reference(runs, name):
    want = np.load(runs / f"{name}.npy")
    got = np.load(runs / f"{name}.port.npz")["logits"]
    assert got.shape == want.shape == (M.DECODE_SEQ, _case(name)["batch"],
                                       512)
    for i in range(M.DECODE_SEQ):
        err = float(np.abs(got[i] - want[i]).max())
        assert err <= _tol(want[i], LOGITS_RTOL), (name, i, err)


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_decode_matches_meshless(runs, meshless, name):
    want = np.load(runs / f"{name}.npy")
    got = np.load(runs / f"{name}.port.npz")["logits"]
    one = meshless[name]
    for i in range(M.DECODE_SEQ):
        err = float(np.abs(got[i] - one[i]).max())
        assert err <= _tol(want[i], MESHLESS_RTOL), (name, i, err)


def _reference_cache(runs, name, cfg):
    """The reference's last cache (its prefix / scanned-stack layout) by
    the port's per-layer paths."""
    from repro_torch.checkpoint import read_tree
    from repro_torch.models import transformer as T
    tree = read_tree(str(runs / name / "cache"), 0)
    prefix, period, nblocks = T.stage_plan(cfg)
    layers = list(tree.get("prefix", []))
    for bi in range(nblocks):
        for j in range(len(period)):
            layers.append({k: v[bi]
                           for k, v in tree["stack"][f"sub{j}"].items()})
    return {f"layers/{i}/{k}": v.float().numpy()
            for i, layer in enumerate(layers) for k, v in layer.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_cache_matches_reference(runs, name):
    cfg = M._cfg(_case(name)["arch"], _case(name).get("cfg"))
    want = _reference_cache(runs, name, cfg)
    got = np.load(runs / f"{name}.port.npz")
    keys = {k[len("cache:"):] for k in got.files if k.startswith("cache:")}
    assert keys == set(want)
    for k, w in want.items():
        g = got[f"cache:{k}"]
        assert g.shape == w.shape, (name, k)
        err = float(np.abs(g - w).max())
        assert err <= _tol(w, CACHE_RTOL), (name, k, err)


@pytest.mark.parametrize("name", list(CASES))
def test_serve_step_next_tokens_match_reference(runs, name):
    """Where the reference's top two logits differ by more than the
    logits' tolerance, ``serve_step``'s next token is its argmax."""
    want = np.load(runs / f"{name}.npy")
    got = np.load(runs / f"{name}.port.npz")["next"]
    assert got.dtype == np.int32
    decided = 0
    for i in range(M.DECODE_SEQ):
        top2 = np.sort(want[i], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > _tol(want[i], LOGITS_RTOL)
        assert np.array_equal(got[i][clear],
                              np.argmax(want[i], -1)[clear]), (name, i)
        decided += int(clear.sum())
    assert decided > M.DECODE_SEQ * _case(name)["batch"] // 2


def test_sparse_shards_are_the_pruned_weights(runs):
    """Every rank's BCSR shard, gathered whole as a dense weight, equals
    the pruned weight the reference decoded, bit for bit; every 2-D
    projection of the config was converted and keeps between a tenth and
    three tenths of its weights; each tp shard's W^T is pruned tile by tile
    of the reference's block of the whole weight
    (``sparse_weights.reference_block``): every tile zero or kept whole,
    some tiles kept and between a tenth and three tenths of them (the
    widened config's shards hold 4 or 8 tiles and keep a quarter)."""
    from repro_torch.launch.sparse_weights import reference_block
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_paths
    cfg, params = _params(runs, "yi_sparse_2x2")
    tp = _case("yi_sparse_2x2")["shape"][1]
    specs = dict(tree_paths(T.param_specs(cfg, tp)))
    whole = dict(tree_paths(params))
    got = np.load(runs / "yi_sparse_2x2.port.npz")
    conv = {k[len("bcsr:"):] for k in got.files if k.startswith("bcsr:")}
    names = {k.split("/")[-1] for k in conv}
    assert names == {"wq", "wk", "wv", "wo", "gate", "up", "down"}, names
    for k in conv:
        w = whole[k].numpy()
        assert np.array_equal(got[f"bcsr:{k}"], w), k
        assert 0.1 < np.mean(w != 0) < 0.3, k
        n_in, n_out = w.shape
        bm, bn = reference_block(n_out, n_in, tp)
        axis = [i for i, e in enumerate(specs[k]) if e == "tp"]
        for shard in (np.split(w, tp, axis=axis[0]) if axis else [w]):
            wt = shard.T
            gm, gn = -(-wt.shape[0] // bm), -(-wt.shape[1] // bn)
            pad = ((0, gm * bm - wt.shape[0]), (0, gn * bn - wt.shape[1]))

            def tiled(a):
                return np.pad(a, pad).reshape(gm, bm, gn, bn).transpose(
                    0, 2, 1, 3)

            tiles, inside = tiled(wt != 0), tiled(np.ones(wt.shape, bool))
            kept = tiles.any(axis=(2, 3))
            assert bool((tiles | ~inside)[kept].all()), k   # kept whole
            assert kept.sum() > 0, k
            assert 0.1 < kept.mean() < 0.3, (k, kept.sum(), kept.size)


def test_distributed_argmax_takes_the_first_maximum(runs):
    res = json.loads((runs / "argmax.json").read_text())
    assert res["got"] == res["want"] == [9, 2, 0, 31]
