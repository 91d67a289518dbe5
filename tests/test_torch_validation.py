"""far_tpu_torch's validation against the JAX package's, on the CPU.

The metrics (``eval/metrics.py``), the samplers, the loader and collate,
the string helpers of ``parallel/comm.py`` and the synthetic pairs'
metadata, each against its JAX counterpart on the same seeded inputs;
then ``train/validation.py:validate_far`` against
``far_tpu/train/validation.py:validate_far``: on JAX's own per-pair
arrays (the tables equal exactly) and end to end with the network
guard's trained weights (``assets/tiny_guard.npz``), the port replaying
JAX's per-batch sampler draws. Each tolerance is stated where it is
checked.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far_tpu.train.validation as jvalidation
import far_tpu_torch.train.validation as tvalidation
from far_tpu.data import Loader as JLoader
from far_tpu.data import SyntheticPairDataset as JSyntheticPairDataset
from far_tpu.data import loader as jloader
from far_tpu.data import sampler as jsampler
from far_tpu.eval import metrics as jmetrics
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.parallel import comm as jcomm
from far_tpu.pipeline import build_inference_fn as jbuild_inference_fn
from far_tpu.solvers.pose_estimation import default_prior_pcl
from far_tpu_torch.data import loader as tloader
from far_tpu_torch.data import sampler as tsampler
from far_tpu_torch.data.synthetic import SyntheticPairDataset
from far_tpu_torch.eval import metrics as tmetrics
from far_tpu_torch.parallel import comm as tcomm
from far_tpu_torch.tools.guard import GUARD_NPZ, gate_deg, load_guard
from far_tpu_torch.utils.convert_weights import load_flax_npz
from test_torch_guard import _jax_tiny_config

torch.set_num_threads(2)


# ---- metrics ---------------------------------------------------------------


def _rotations(rng, n, max_deg=60.0):
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    ang = np.radians(rng.uniform(0.0, max_deg, n))
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -ax[:, 2], ax[:, 1], -ax[:, 0]
    K = K - np.swapaxes(K, 1, 2)
    s, c = np.sin(ang)[:, None, None], np.cos(ang)[:, None, None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def _metric_dict(seed, n=12, repeats=3, empty=(2, 5)):
    """Per-pair metric lists as validate_far gathers them, with repeated
    identifiers (a padded sampler's) and pairs without matches."""
    rng = np.random.default_rng(seed)
    ids = [f"syn_{i}_0#syn_{i}_1" for i in range(n)] + \
        [f"syn_{i}_0#syn_{i}_1" for i in rng.choice(n, repeats, replace=False)]
    m = len(ids)
    epi = [rng.exponential(1e-3, rng.integers(1, 40)).astype(np.float32) for _ in range(m)]
    for i in empty:
        epi[i] = np.zeros(0, np.float32)
    return {"identifiers": ids,
            "R_errs": list(rng.exponential(8.0, m)),
            "t_errs": list(rng.exponential(15.0, m)),
            "t_errs_abs": list(rng.exponential(0.8, m)),
            "successful_fits": list((rng.uniform(size=m) < 0.8).astype(float)),
            "epi_errs": epi,
            "gt_R": _rotations(rng, m, 89.0),
            "pred_R": _rotations(rng, m, 89.0)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_tables_match_jax(seed):
    """aggregate_metrics (with the dedup by identifier and pairs without a
    match) and the InteriorNet/StreetLearn split: equal to JAX's, exactly
    (NaN where JAX has NaN)."""
    m = _metric_dict(seed)
    assert tmetrics._dedup_ids(m["identifiers"]) == jmetrics._dedup_ids(m["identifiers"])
    for thr in (5e-4, 1e-3):
        np.testing.assert_equal(tmetrics.aggregate_metrics(m, thr),
                                jmetrics.aggregate_metrics(m, thr))
        np.testing.assert_equal(tmetrics.aggregate_metrics_interiornet_streetlearn(m, thr),
                                jmetrics.aggregate_metrics_interiornet_streetlearn(m, thr))
    # a split with one side empty gives NaN rows in both
    m["gt_R"] = _rotations(np.random.default_rng(seed), len(m["identifiers"]), 30.0)
    np.testing.assert_equal(tmetrics.aggregate_metrics_interiornet_streetlearn(m),
                            jmetrics.aggregate_metrics_interiornet_streetlearn(m))


def test_per_pair_errors_match_jax():
    """relative_pose_error (float32 and float64 inputs, the +-t ambiguity,
    the near-pure-rotation threshold), rotation_angles_deg, geodesic_deg,
    pose_error, a_metrics, error_auc and epidist_prec: within 1e-12 of
    JAX's (the same numpy code; 0 in practice)."""
    rng = np.random.default_rng(3)
    Rs = _rotations(rng, 8)
    Rp = _rotations(rng, 8)
    ts = rng.normal(size=(8, 3))
    tp = rng.normal(size=(8, 3))
    for i in range(8):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = Rs[i], ts[i] * (0.01 if i == 3 else 1.0)
        for dt in (np.float32, np.float64):
            for thr in (0.0, 0.1):
                for sign in (1.0, -1.0):
                    args = (T.astype(dt), Rp[i].astype(dt), (sign * tp[i]).astype(dt), thr)
                    np.testing.assert_allclose(tmetrics.relative_pose_error(*args),
                                               jmetrics.relative_pose_error(*args),
                                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tmetrics.rotation_angles_deg(Rs),
                               jmetrics.rotation_angles_deg(Rs), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tmetrics.geodesic_deg(Rs, Rp),
                               jmetrics.geodesic_deg(Rs, Rp), rtol=0, atol=1e-12)
    ours, ref = tmetrics.pose_error(Rs, ts, Rp, tp), jmetrics.pose_error(Rs, ts, Rp, tp)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-12)
    scale = ours["t_err_scale"]
    assert tmetrics.a_metrics(scale) == jmetrics.a_metrics(scale)
    errs = rng.exponential(9.0, 30)
    for thrs in ((5, 10, 20), (1, 3)):
        assert tmetrics.error_auc(errs, thrs) == jmetrics.error_auc(errs, thrs)
    per_pair = [rng.exponential(1e-3, k) for k in (0, 5, 17)]
    for ret in (False, True):
        assert tmetrics.epidist_prec(per_pair, [5e-4, 1e-3], ret) == \
            jmetrics.epidist_prec(per_pair, [5e-4, 1e-3], ret)
    assert tmetrics.epidist_prec([], [5e-4]) == jmetrics.epidist_prec([], [5e-4]) == [0.0]


def test_metrics_accumulator_matches_jax():
    ours, ref = tmetrics.MetricsAccumulator(), jmetrics.MetricsAccumulator()
    rng = np.random.default_rng(4)
    for _ in range(3):
        kw = dict(R_err=rng.normal(size=4), t=rng.normal(size=(4, 3)))
        ours.update(**kw)
        ref.update(**kw)
    a, b = ours.accumulate(), ref.accumulate()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---- samplers ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("world_size", [1, 3])
def test_samplers_match_jax(seed, world_size):
    """The same index arrays as JAX's for every rank, with and without
    replacement, shuffle, repetition and padding."""
    lengths = [5, 0, 11, 3]
    for rank in range(world_size):
        for replacement in (True, False):
            for shuffle in (True, False):
                for repeat in (1, 3):
                    kw = dict(replacement=replacement, shuffle=shuffle, repeat=repeat,
                              rank=rank, world_size=world_size)
                    np.testing.assert_array_equal(
                        tsampler.scene_balance_indices(lengths, 4, seed, **kw),
                        jsampler.scene_balance_indices(lengths, 4, seed, **kw))
            for num in (None, 10):
                kw = dict(num_samples=num, seed=seed, replacement=replacement,
                          rank=rank, world_size=world_size)
                np.testing.assert_array_equal(tsampler.random_indices(13, **kw),
                                              jsampler.random_indices(13, **kw))
        for n in (10, 11, 12):
            for pad in (True, False):
                np.testing.assert_array_equal(
                    tsampler.sequential_indices(n, rank, world_size, pad),
                    jsampler.sequential_indices(n, rank, world_size, pad))


# ---- loader and collate --------------------------------------------------------


def test_synthetic_metadata_matches_jax():
    """scene, pair_names, dataset_name and pair_id of the port's synthetic
    pairs equal JAX's SyntheticPairDataset's, with every array."""
    ours = SyntheticPairDataset(n=6, hw=(32, 48), seed=3, n_scenes=4)
    ref = JSyntheticPairDataset(n=6, hw=(32, 48), seed=3, n_scenes=4)
    for i in range(6):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in ("scene", "pair_names", "dataset_name"):
            assert a[k] == b[k], (i, k)
        for k, v in a.items():
            np.testing.assert_array_equal(v, b[k], err_msg=f"{i} {k}")


def _assert_batch_equal(tb, jb):
    for k in ("image0", "image1", "K0", "K1", "T_0to1", "T_1to0", "depth0", "depth1",
              "pair_id"):
        ours = getattr(tb, k)
        assert ours.device.type == "cpu"
        np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    assert tb.image0.dtype == torch.float32 and tb.pair_id.dtype == torch.int64
    assert tb.scale0 is None and jb.scale0 is None


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_matches_jax(workers):
    """The same batches in the same order as JAX's Loader (10 items at
    B=3: the tail of 1 dropped), with keep_meta's names and scenes."""
    ours = SyntheticPairDataset(n=10, hw=(32, 32), seed=1, n_scenes=3)
    ref = JSyntheticPairDataset(n=10, hw=(32, 32), seed=1, n_scenes=3)
    idx = np.random.default_rng(2).permutation(10)
    a = list(tloader.Loader(ours, idx, 3, keep_meta=True, workers=workers, prefetch=1))
    b = list(JLoader(ref, idx, 3, keep_meta=True, workers=workers, prefetch=1))
    assert len(a) == len(b) == 3
    for (tb, tm), (jb, jm) in zip(a, b):
        _assert_batch_equal(tb, jb)
        assert tm == jm
    plain = list(tloader.Loader(ours, idx, 4, workers=workers))
    assert len(plain) == 2 and all(isinstance(x, type(a[0][0])) for x in plain)


def test_collate_optional_fields():
    """An optional field goes in only where every sample has it, as JAX's."""
    ds = SyntheticPairDataset(n=2, hw=(16, 16))
    s0, s1 = ds[0], ds[1]
    s0["scale0"] = s1["scale0"] = np.array([1.0, 0.5], np.float32)
    s1["scale1"] = np.array([2.0, 2.0], np.float32)
    del s1["depth1"]
    tb, jb = tloader.collate_pairs([s0, s1]), jloader.collate_pairs([s0, s1])
    for k in ("T_0to1", "T_1to0", "depth0", "depth1", "scale0", "scale1"):
        j = getattr(jb, k)
        t = getattr(tb, k)
        assert (t is None) == (j is None), k
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    moved = tloader.to_device(tb, "cpu")
    assert moved.depth1 is None and torch.equal(moved.scale0, tb.scale0)


def test_loader_raises_a_workers_error():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("item 5 is broken")
            return SyntheticPairDataset(n=8, hw=(16, 16))[i]

    for workers in (1, 2):
        got = []
        with pytest.raises(KeyError, match="item 5"):
            for batch in tloader.Loader(Broken(), np.arange(8), 2, workers=workers):
                got.append(batch)
        assert len(got) == 2   # batches 0 and 1; batch 2 holds item 5
    assert threading.active_count() < 20


# ---- comm ----------------------------------------------------------------------


def test_comm_strings_and_gather_match_jax():
    """encode_strings' bytes equal JAX's (utf-8, cut at the width), the
    round trip restores the strings, and all_gather_metrics is the
    identity in one process."""
    strings = ["syn_0_0#syn_0_1", "scène/ü#b", "x" * 120, ""]
    for width in (8, 96):
        ours = tcomm.encode_strings(strings, width)
        np.testing.assert_array_equal(ours, jcomm.encode_strings(strings, width))
        assert tcomm.decode_strings(ours) == jcomm.decode_strings(ours)
    assert tcomm.decode_strings(tcomm.encode_strings(strings[:2])) == strings[:2]
    metrics = {"R_errs": np.arange(3.0), "identifiers": tcomm.encode_strings(strings[:3])}
    assert tcomm.all_gather_metrics(metrics) is metrics
    assert (tcomm.process_index(), tcomm.process_count()) == (0, 1)


# ---- validate_far ----------------------------------------------------------------

SEED, N, BATCH = 4242, 16, 8


def _uniforms(cfg, key):
    """far_tpu/pipeline.py:94,106's sampler draws from one batch's key."""
    so = cfg.solver
    k0, k1 = jax.random.split(key)
    keys = [k0] + list(jax.random.split(k1, so.fine_pred_steps - 1))
    hyps = [so.num_hypotheses] + [so.refine_num_hypotheses] * (so.fine_pred_steps - 1)
    return [torch.from_numpy(np.array(jax.random.uniform(k, (BATCH, max(h // 20, 1), 5))))
            for k, h in zip(keys, hyps)]


@pytest.fixture(scope="module")
def jax_validation():
    """JAX's validate_far with the guard's weights on its 16 pairs, B=8,
    PRNGKey(7): the table, the per-pair lists it aggregated, and the
    per-batch draws (validate_far splits its key once a batch)."""
    variables, _ = load_flax_npz(GUARD_NPZ)
    cfg = _jax_tiny_config()
    ds = JSyntheticPairDataset(n=N, hw=cfg.image_size, seed=SEED, n_scenes=N,
                               max_angle_deg=12.0)
    seen = {}
    real = jvalidation.aggregate_metrics
    mp = pytest.MonkeyPatch()
    mp.setattr(jvalidation, "aggregate_metrics", lambda acc: seen.update(acc) or real(acc))
    key = jax.random.PRNGKey(7)
    table = jvalidation.validate_far(jbuild_inference_fn(JFARLoFTR(cfg)),
                                     jax.tree.map(jnp.asarray, variables), ds, BATCH, key,
                                     cfg.match.max_matches)
    mp.undo()
    uniforms = []
    for _ in range(N // BATCH):
        key, sub = jax.random.split(key)
        uniforms.append(_uniforms(cfg, sub))
    return dict(table=table, acc=seen, uniforms=uniforms)


def test_aggregate_of_jax_predictions_equals_jax_table(jax_validation):
    """(a) JAX's own per-pair arrays through the port's aggregate_metrics
    give JAX's table, exactly."""
    np.testing.assert_equal(tmetrics.aggregate_metrics(jax_validation["acc"]),
                            jax_validation["table"])


def test_validate_far_matches_jax(jax_validation, monkeypatch):
    """(b) End to end with the guard's weights and JAX's per-batch draws:
    the identifiers and dset size equal JAX's, every pair's rotation error
    within 1 deg (bf16 rounding before the dual softmax reorders the
    trained model's matches, ROADMAP Queue 3), the table's medians under
    the guard's gate, and every epipolar row at most max_matches long."""
    seen = {}
    real = tvalidation.aggregate_metrics
    monkeypatch.setattr(tvalidation, "aggregate_metrics",
                        lambda acc: seen.update(acc) or real(acc))
    model, meta = load_guard(device="cpu")
    ds = SyntheticPairDataset(n=N, hw=model.config.image_size, seed=SEED, n_scenes=N,
                              max_angle_deg=12.0)
    table = tvalidation.validate_far(
        model, ds, BATCH, uniforms=jax_validation["uniforms"],
        prior_pcl=torch.from_numpy(np.array(default_prior_pcl())))
    ref, jacc = jax_validation["table"], jax_validation["acc"]
    assert table.keys() == ref.keys()
    assert seen["identifiers"] == jacc["identifiers"] == \
        [f"syn_{i}_0#syn_{i}_1" for i in range(N)]
    assert table["dset size"] == ref["dset size"] == N
    diff = np.abs(np.asarray(seen["R_errs"]) - np.asarray(jacc["R_errs"]))
    assert diff.max() < 1.0, np.stack([seen["R_errs"], jacc["R_errs"]])
    assert table["rot median err"] < gate_deg(meta)
    assert all(len(e) <= model.config.match.max_matches for e in seen["epi_errs"])
    assert all(np.isfinite(v) for v in table.values())


def test_all_gather_refuses_several_processes(monkeypatch):
    """At a world size above 1 all_gather_metrics gathers over the process
    group (tests/test_torch_distributed.py runs it on gloo ranks); without
    a group to gather over it raises rather than return one process's rows
    as if they were every process's."""
    monkeypatch.setattr(tcomm, "process_count", lambda: 2)
    with pytest.raises((RuntimeError, ValueError), match="process group"):
        tcomm.all_gather_metrics({"R_errs": np.zeros(2)})
