"""far_tpu_torch's data parallelism on the CPU: gloo ranks against one process and JAX.

Two ranks (and a group of one) are started as subprocesses on a free
localhost port, with the environment ``torch.distributed.run`` sets,
each running ``tests/torch_ddp_worker.py`` under a timeout of its own;
they save what they computed, and the tests hold it against the port's
one-process step on the whole batch (no process group) and, for the FAR
step, against ``far_tpu.train.trainer.make_train_step`` jitted over a
2-device ``Mesh`` (conftest's virtual CPU devices), as
``__graft_entry__.dryrun_multichip`` runs it. The solver is
``torch_ddp_worker.fixed_solver`` (and its JAX twin): a result that
depends on each pair alone, so a step does not hinge on RANSAC's
near-ties. Every tolerance is stated where it is checked.
"""

import dataclasses
import functools
import math
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import far_tpu.eval.metrics as jmetrics
import far_tpu.train.trainer as jtrainer
import far_tpu_torch.cli.evaluate as tevaluate
import far_tpu_torch.cli.train as ttrain
import far_tpu_torch.pipeline as tpipeline
import far_tpu_torch.train.family_trainers as tfam
import far_tpu_torch.train.trainer as ttrainer
from far_tpu.models.loftr import FARLoFTR as JFARLoFTR
from far_tpu.utils import config as jconfig
from far_tpu.utils.convert_weights import convert_loftr_state_dict
from far_tpu_torch.data import synthetic as tdata
from far_tpu_torch.models.backbone import bn
from far_tpu_torch.models.sixdreg import MapfreeRegression, SixDRegConfig
from far_tpu_torch.models.vitess import ViTEss, ViTEssConfig
from far_tpu_torch.parallel import comm
from far_tpu_torch.train.supervision import coarse_supervision
from far_tpu_torch.utils import config as tconfig
from far_tpu_torch.utils.convert_weights import flax_to_state_dict, init_weights
from far_tpu_torch.utils.float64 import float64_compute
from test_torch_cli import SETS
from test_torch_modules import small_config
from test_torch_train import pairs
from torch_ddp_worker import fixed_solver, params_and_stats, sgd_steps

torch.set_num_threads(2)
WORKER = Path(__file__).with_name("torch_ddp_worker.py")
ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180
JOBS = ["collectives", "bn", "far", "remat", "vitess", "sixdreg1", "sixdreg0",
        "cli_train", "cli_evaluate"]
HW = (64, 64)
N_EVAL = 5   # an odd pair count: the second rank's shard repeats the first pair


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(work: Path, jobs, world: int):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "2",
               "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen([sys.executable, str(WORKER), str(work), *jobs],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs) -> str:
    """Every rank's output; every rank killed after TIMEOUT_S."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return "\n".join(f"rank {r} rc {p.returncode}:\n{log[-3000:]}"
                     for r, (p, log) in enumerate(zip(procs, logs)))


def _stubbed(monkeypatch):
    for mod in (tpipeline, tfam, ttrainer):
        monkeypatch.setattr(mod, "estimate_pose", fixed_solver)


def _train_argv(tmp: Path, name: str):
    return ["--dataset", "synthetic", "--image_size", "64x64", "--n_synthetic", "8",
            "--batch_size", "2", "--dtype", "float32", "--device", "cpu", "--steps", "2",
            "--log_every", "1", "--sampler", "sequential", "--lr", "1e-3",
            "--ckpt_dir", str(tmp / name / "ckpt"), "--log_dir", str(tmp / name / "logs")
            ] + SETS


def _evaluate_argv(tmp: Path, name: str):
    return ["--dataset", "synthetic", "--image_size", "64x64", "--n_synthetic", str(N_EVAL),
            "--batch_size", "1", "--dtype", "float32", "--device", "cpu",
            "--out_dir", str(tmp / name)] + SETS


def _inputs(tmp: Path) -> dict:
    rng = np.random.default_rng(0)
    far_cfg = small_config(tconfig)
    far = ttrainer.Trainer(far_cfg, device="cpu").init(seed=0)
    # tests/test_torch_family_train.py's small configurations
    vitess_cfg = ViTEssConfig(dim=48, depth=2, num_heads=3, fc_hidden=64, dtype="float32",
                              use_loftr_gating=True)
    sixdreg_cfg = SixDRegConfig(image_hw=HW, encoder_blocks=(1, 1, 1), encoder_out_layers=8,
                                transformer_layers=1, transformer_heads=2, hidden=64,
                                dtype="float32")
    ds = tdata.SolverPoseDataset(tdata.SyntheticPairDataset(n=4, hw=HW, seed=0), seed=0)
    gt = tdata.GTCorrespondenceDataset(tdata.SyntheticPairDataset(n=4, hw=HW, seed=0),
                                       max_matches=128)
    bn_state = torch.nn.BatchNorm2d(6).state_dict()
    bn_state.update(weight=torch.from_numpy(rng.normal(1, 0.2, 6).astype(np.float32)),
                    bias=torch.from_numpy(rng.normal(0, 0.2, 6).astype(np.float32)),
                    running_mean=torch.from_numpy(rng.normal(0, 1, 6).astype(np.float32)))
    return dict(
        n_pairs=N_EVAL,
        bn_x=torch.from_numpy(rng.normal(0.5, 2.0, (4, 6, 5, 7)).astype(np.float32)),
        bn_g=torch.from_numpy(rng.normal(size=(4, 6, 5, 7)).astype(np.float32)),
        bn_state=bn_state,
        far_cfg=far_cfg, far_sd=params_and_stats(far.model), far_batch=pairs(HW)[0],
        vitess_cfg=vitess_cfg,
        vitess_sd=init_weights(ViTEss(vitess_cfg), 1).state_dict(),
        vitess_batch=tfam.collate_vitess([ds[i] for i in range(4)], "cpu"),
        sixdreg_cfg=sixdreg_cfg,
        sixdreg_sd=init_weights(MapfreeRegression(sixdreg_cfg), 2).state_dict(),
        sixdreg_batch=tfam.collate_sixdreg([gt[i] for i in range(4)], "cpu"),
        train_argv=_train_argv(tmp, "ddp_train"),
        evaluate_argv=_evaluate_argv(tmp, "ddp_eval"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two ranks running every job, a group of one running ``world1``, and
    the one-process references computed meanwhile. Returns (work dir,
    inputs, {job: [rank 0's result, rank 1's]}, world1's result,
    references)."""
    work = tmp_path_factory.mktemp("ddp")
    inp = _inputs(work)
    torch.save(inp, work / "inputs.pt")
    procs = _launch(work, JOBS, 2) + _launch(work, ["world1"], 1)
    mp = pytest.MonkeyPatch()
    try:
        _stubbed(mp)
        refs = _references(work, inp)
    finally:
        mp.undo()
        log = _wait(procs)
    errs = {p.name: p.read_text() for p in work.glob("*.err")}
    load = lambda name: torch.load(work / name, weights_only=False)
    results = {job: [load(f"{job}.rank{r}.pt") for r in range(2)]
               for job in JOBS if (work / f"{job}.rank1.pt").exists()}
    world1 = load("world1.rank0.pt") if (work / "world1.rank0.pt").exists() else None
    return dict(work=work, inp=inp, results=results, world1=world1, refs=refs,
                log=log, errs=errs)


def _job(runs, job):
    if job not in runs["results"]:
        pytest.fail(f"job {job} left no result: {runs['errs']}\n{runs['log']}")
    return runs["results"][job]


def _references(work: Path, inp: dict) -> dict:
    """The one-process runs (no process group) on the whole batch."""
    def far(**over):
        tr = ttrainer.Trainer(dataclasses.replace(inp["far_cfg"], **over), device="cpu")
        tr.model.load_state_dict(inp["far_sd"])
        return tr

    def family(name, **kw):
        cfg = inp[f"{name}_cfg"]
        tr = tfam.ViTEssTrainer(cfg, device="cpu") if name == "vitess" \
            else tfam.SixDRegTrainer(cfg, device="cpu", **kw)
        tr.model.load_state_dict(inp[f"{name}_sd"])
        return sgd_steps(tr, inp[f"{name}_batch"], 2, f64=True)

    m = torch.nn.BatchNorm2d(6)
    m.load_state_dict(inp["bn_state"])
    x = inp["bn_x"].clone().requires_grad_(True)
    y = bn(x, m)
    (y * inp["bn_g"]).sum().backward()
    with float64_compute():
        train_trainer = ttrain.main(_train_argv(work, "one_train"))
    return dict(
        bn={"y": y.detach(), "dx": x.grad, "dw": m.weight.grad, "db": m.bias.grad,
            "running_mean": m.running_mean, "running_var": m.running_var},
        far=sgd_steps(far(), inp["far_batch"], 2, f64=True),
        vitess=family("vitess"), sixdreg1=family("sixdreg", lam=1.0),
        sixdreg0=family("sixdreg", lam=0.0),
        cli_train=params_and_stats(train_trainer.model),
        cli_evaluate=tevaluate.main(_evaluate_argv(work, "one_eval")))


def _close(out, ref, rel, what):
    """|out - ref| <= rel max|ref| elementwise."""
    out = out.detach().double().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = ref.detach().double().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, err_msg=what,
                               atol=rel * max(float(np.abs(ref).max(initial=0.0)), 1e-30))


def _check_step(got, ref, start, rel_metric, rel_delta, rel_stats, zero_grad=()):
    """The first step's metrics within ``rel_metric`` relative, every
    parameter's change (SGD(1): minus the gradient) within ``rel_delta``
    max|ref change| plus one rounding of max|p|, the running statistics
    within ``rel_stats`` relative, the trainer's own parameters within
    ``rel_delta``. ``zero_grad``: tensors whose exact gradient is 0
    (biases before a train-mode BatchNorm), held to 1e-5 of their
    weight's change. (A second SGD(1) step starts from weights moved by a
    gradient of norm ~1e3 and only amplifies the first one's rounding.)"""
    m, mr = got["metrics"][0], ref["metrics"][0]
    assert m.keys() == mr.keys()
    for k, v in mr.items():
        assert abs(m[k] - v) <= rel_metric * max(abs(v), 1e-30), (k, m[k], v)
    s, sr = got["states"][0], ref["states"][0]
    for k, v in sr.items():
        if k.endswith(("running_mean", "running_var")):
            _close(s[k], v, rel_stats, k)
        elif v.is_floating_point():
            d, dr = s[k] - start[k], v - start[k]
            ulp = 2.0 ** -23 * float(start[k].abs().max())
            if k in zero_grad:
                w = k[:-4] + "weight"
                scale = 1e-5 * float((sr[w] - start[w]).abs().max()) + ulp
                assert float(d.abs().max()) <= scale and float(dr.abs().max()) <= scale, k
                continue
            np.testing.assert_allclose(d.numpy(), dr.numpy(), rtol=0, err_msg=k,
                                       atol=rel_delta * float(dr.abs().max()) + ulp)
    for k, v in ref["extra"][0].items():
        _close(got["extra"][0][k], v, rel_delta, k)


def _ranks_agree(out):
    """Both ranks report the same metrics and hold the same state after
    each step (the second step also shows DDP found every gradient)."""
    assert out[0]["metrics"] == out[1]["metrics"]
    assert all(np.isfinite(v) for m in out[0]["metrics"] for v in m.values())
    for a, b in zip(out[0]["states"], out[1]["states"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


# ---- the collectives --------------------------------------------------------------


def test_all_reduce_sum_values_and_gradients(runs):
    """y = sum_r x_r^2 on every rank; rank r's loss is (r + 1) sum(y), so
    the gradient of x_r is 2 x_r sum_q (q + 1) = 6 x_r; the metric means
    are the ranks' means."""
    out = _job(runs, "collectives")
    x = [torch.arange(4, dtype=torch.float64) + 10 * r for r in range(2)]
    for r in range(2):
        assert torch.equal(out[r]["y"], x[0] ** 2 + x[1] ** 2)
        assert torch.equal(out[r]["grad"], 6 * x[r])
        assert out[r]["scalars"] == {"a": 0.5, "b": 2.5}


def test_all_gather_metrics_odd_pairs_dedup(runs):
    """5 pairs over 2 ranks: rank 0 holds 0, 2, 4 and rank 1 holds 1, 3 and
    the repeat of 0. The gathered arrays are rank 0's rows then rank 1's
    for every dtype (a 0-d array a row a rank), the same on both ranks;
    gather_pair_metrics keeps every row, and aggregate_metrics drops the
    repeat by identifier: 5 pairs, as tests/mp_gather_worker.py expects of
    JAX's, and the table JAX's aggregate_metrics makes of the same rows
    (the repeat's copy it keeps is rank 1's, whose rotation error differs)."""
    out = _job(runs, "collectives")
    order = [0, 2, 4, 1, 3, 0]
    ranks = [0, 0, 0, 1, 1, 1]
    for r in range(2):
        raw = out[r]["raw"]
        assert comm.decode_strings(raw["identifiers"]) == [f"scene#pair{i}" for i in order]
        assert raw["f32"].dtype == np.float32 and list(raw["f32"]) == order
        assert raw["f64"].dtype == np.float64 and list(raw["f64"]) == order
        assert raw["i64"].dtype == np.int64 and list(raw["i64"]) == order
        assert raw["flags"].dtype == bool and list(raw["flags"]) == [i % 2 == 0 for i in order]
        assert list(raw["scalar"]) == [0.0, 1.0]
        pairs = out[r]["pairs"]
        assert pairs["identifiers"] == [f"scene#pair{i}" for i in order]
        assert pairs["R_errs"] == [i + 0.25 * k for i, k in zip(order, ranks)]
        assert [len(e) for e in pairs["epi_errs"]] == [min(i + 1, 4) for i in order]
        table = out[r]["table"]
        assert table["dset size"] == N_EVAL
        jtable = jmetrics.aggregate_metrics(pairs)
        assert table.keys() == jtable.keys()
        for k, v in jtable.items():
            assert table[k] == v or (np.isnan(v) and np.isnan(table[k])), (r, k, table[k], v)
    assert out[0]["table"] == out[1]["table"]


def test_bn_two_ranks_match_concatenated_batch(runs):
    """bn on 2 ranks of 2 rows against bn on the 4 rows in one process, in
    float32: outputs, the gradients of x (every rank's term included) and
    of the weight and bias (summed over ranks, as DDP's sum would be), and
    the running statistics within 1e-6 max|ref|; the statistics equal on
    both ranks."""
    out, ref = _job(runs, "bn"), runs["refs"]["bn"]
    _close(torch.cat([o["y"] for o in out]), ref["y"], 1e-6, "y")
    _close(torch.cat([o["dx"] for o in out]), ref["dx"], 1e-6, "dx")
    for k in ("dw", "db"):
        _close(out[0][k] + out[1][k], ref[k], 1e-6, k)
    for k in ("running_mean", "running_var"):
        _close(out[0][k], ref[k], 1e-6, k)
        assert torch.equal(out[0][k], out[1][k]), k


# ---- the FAR step ----------------------------------------------------------------------


def test_far_two_ranks_match_one_process(runs):
    """One SGD(1) step of the small FAR on 2 ranks x 1 pair against the
    port's one-process step on both pairs: losses and grad_norm within
    1e-5 relative, every parameter's change within 1e-5 max|ref| (plus
    one rounding of max|p|), the running statistics within 1e-6, and the
    ranks' states equal. The pairs' coarse positives differ (a masked
    mean over local counts would weigh them wrongly)."""
    out, ref = [o["f64"] for o in _job(runs, "far")], runs["refs"]["far"]
    cfg, batch = runs["inp"]["far_cfg"], runs["inp"]["far_batch"]
    conf_gt, _, _ = coarse_supervision(batch, cfg.coarse_hw, 8.0)
    positives = conf_gt.flatten(1).sum(-1)
    assert positives.min() >= 1 and positives[0] != positives[1], positives
    _ranks_agree(out)
    _check_step(out[0], ref, runs["inp"]["far_sd"], 1e-5, 1e-5, 1e-6)


def _jax_solver(key, kp0, kp1, K0, K1, valid, **kw):
    """fixed_solver's JAX twin."""
    B = kp0.shape[0]
    c, s = math.cos(0.2), math.sin(0.2)
    R = jnp.broadcast_to(jnp.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], jnp.float32), (B, 3, 3))
    t = jnp.broadcast_to(jnp.array([0.3, -0.1, 0.9], jnp.float32), (B, 3))
    n = valid.astype(jnp.float32).sum(-1)
    return types.SimpleNamespace(rt34=jnp.concatenate([R, t[..., None]], -1),
                                 num_inliers=jnp.floor(0.5 * n), num_tight=jnp.floor(0.1 * n),
                                 num_ultra_tight=jnp.zeros(B), success=jnp.ones(B, bool))


# the backbone tensors whose JAX float32 gradient is 5e-2 off on the CPU
# (tests/test_torch_train.py: test_backbone_train_grads_against_jax_float64)
_BACKBONE_STAGES = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.",
                    "backbone.layer2.", "backbone.layer3.0.")


def test_far_two_ranks_match_jax_mesh(runs, monkeypatch):
    """The 2-rank step against make_train_step(optax.sgd(1.0)) jitted with
    the batch sharded over Mesh(jax.devices()[:2], ("data",)), at
    test_train_step_matches_jax's tolerances: losses and grad_norm within
    1e-4 relative, every parameter's change within 1e-4 max|ref| (5e-2 in
    the backbone's first stages) plus one rounding of max|p|, the running
    statistics within 1e-5 relative."""
    out = _job(runs, "far")[0]["f32"]
    inp = runs["inp"]
    sd = {k: v.numpy() for k, v in inp["far_sd"].items()}
    jcfg = small_config(jconfig)
    jmodel = JFARLoFTR(jcfg)
    _, jb = pairs(HW)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jb))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_loftr_state_dict({f"matcher.{k}": v for k, v in sd.items()},
                                                 zeros, jcfg)
    assert not report["missing"] and not report["unused"], report
    tx = optax.sgd(1.0)
    state = jtrainer.create_train_state(jmodel, variables, tx)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    monkeypatch.setattr(jtrainer, "estimate_pose", _jax_solver)
    step = jax.jit(jtrainer.make_train_step(jmodel, tx),
                   in_shardings=(repl, data, repl), out_shardings=(repl, repl))
    jstate, jmetrics = step(jax.device_put(state, repl), jax.device_put(jb, data),
                            jax.random.PRNGKey(3))
    np_tree = functools.partial(jax.tree.map, np.asarray)
    jstate, jmetrics = np_tree(jstate), np_tree(jmetrics)
    for k, v in out["metrics"][0].items():
        assert abs(v - float(jmetrics[k])) <= 1e-4 * abs(float(jmetrics[k])), k
    delta = jax.tree.map(lambda a, b: a - b, jstate.params, np_tree(variables["params"]))
    ref_delta = flax_to_state_dict({"params": delta, "batch_stats": jstate.batch_stats},
                                   inp["far_cfg"])
    stats = flax_to_state_dict({"params": np_tree(variables["params"]),
                                "batch_stats": jstate.batch_stats}, inp["far_cfg"])
    new = out["states"][0]
    for name, v in new.items():
        if name.endswith(("running_mean", "running_var")):
            _close(v, stats[name], 1e-5, name)
        elif name in ref_delta and not name.endswith("num_batches_tracked"):
            d = (v - inp["far_sd"][name]).numpy()
            ulp = 2.0 ** -23 * float(np.abs(sd[name]).max())
            rel = 5e-2 if name.startswith(_BACKBONE_STAGES) else 1e-4
            np.testing.assert_allclose(d, ref_delta[name], rtol=0, err_msg=name,
                                       atol=rel * float(np.abs(ref_delta[name]).max()) + ulp)


def test_remat_two_ranks_match_no_remat(runs):
    """remat "full" and "selective" on 2 ranks: each step's metrics and
    parameter changes within 1e-6 of the 2-rank step without remat (the
    recomputed BatchNorm all-reduces its moments again inside DDP's
    backward), the running statistics within 1e-7 (moved once)."""
    out = _job(runs, "remat")
    start = runs["inp"]["far_sd"]
    for r in range(2):
        base = out[r]["False"]
        for remat in ("full", "selective"):
            _check_step(out[r][remat], base, start, 1e-6, 1e-6, 1e-7)
    moved = max(float((base["states"][0][k] - start[k]).abs().max())
                for k in start if k.endswith("running_var"))
    assert moved > 1e-3


@pytest.mark.parametrize("job", ["vitess", "sixdreg1", "sixdreg0"])
def test_family_two_ranks_match_one_process(runs, job):
    """An SGD(1) step of ViTEss (gated) and of 6DReg with lam 1 and 0 on
    2 ranks x 2 pairs against one process on the 4 pairs: metrics within
    1e-5 relative, parameter changes within 1e-4 max|ref| (ViTEss's
    ResNet trunk and the ResUNet's first stages are ill-conditioned: two
    float32 orders of one sum differ there by 1e-5 of the change), the
    running statistics within 1e-6; with lam 0, s_r and s_t move and
    agree within 1e-4."""
    out, ref = _job(runs, job), runs["refs"][job]
    family = "vitess" if job == "vitess" else "sixdreg"
    _ranks_agree(out)
    zero = ViTEss.BIAS_BEFORE_BN if family == "vitess" else MapfreeRegression.BIAS_BEFORE_BN
    _check_step(out[0], ref, runs["inp"][f"{family}_sd"], 1e-5, 1e-4, 1e-6, zero)
    if job == "sixdreg0":
        assert sorted(out[0]["extra"][0]) == ["s_r", "s_t"]
        assert all(abs(float(v)) > 0 for v in out[0]["extra"][0].values())


def test_world_size_one_group_is_bit_equal(runs):
    """A gloo group of one runs the step through DDP, bit-equal to the
    step without a process group: metrics and every tensor of the state."""
    w1 = runs["world1"]
    if w1 is None:
        pytest.fail(f"world1 left no result: {runs['errs']}\n{runs['log']}")
    assert w1["ddp"] == "DistributedDataParallel"
    assert w1["grouped"]["metrics"] == w1["plain"]["metrics"]
    for k, v in w1["plain"]["states"][0].items():
        assert torch.equal(w1["grouped"]["states"][0][k], v), k


# ---- the entry points ---------------------------------------------------------------


def test_cli_train_two_ranks(runs):
    """cli.train on 2 gloo ranks, 2 steps at a global batch of 2 (AdamW, lr
    1e-3; the float32 weights computing in float64, see the worker's
    job): rank 0 wrote the one checkpoint, its weights equal to the
    one-process run's within 1e-3 of lr plus a rounding of max|p| a step
    (AdamW divides by |g| + 1e-8: a gradient element near 0 turns a
    1e-13 difference of the float64 sums into 3.4e-5 of lr here, where a
    wrong step moves weights by O(lr)),
    its BatchNorm statistics within 1e-6, the ranks' models equal, and
    --resume took no step."""
    out = _job(runs, "cli_train")
    work = runs["work"]
    ckpts = sorted(p.name for p in (work / "ddp_train" / "ckpt").glob("*.pt"))
    assert ckpts == ["2.pt"]
    saved = torch.load(work / "ddp_train" / "ckpt" / "2.pt", weights_only=False)
    one = torch.load(work / "one_train" / "ckpt" / "2.pt", weights_only=False)
    assert saved["step"] == one["step"] == 2
    for r in range(2):
        assert out[r]["step_count"] == 2 and out[r]["resumed_step_count"] == 2
        for k, v in out[r]["state"].items():
            assert torch.equal(v, saved["model"][k]), k
    moved = 0.0
    for k, v in one["model"].items():
        if k.endswith(("running_mean", "running_var")):
            _close(saved["model"][k], v, 1e-6, k)
        elif v.is_floating_point():
            ulp = 2.0 ** -23 * float(v.abs().max())
            assert float((saved["model"][k] - v).abs().max()) <= 1e-3 * 1e-3 + 2 * ulp, k
            moved = max(moved, float((v - runs["inp"]["far_sd"][k]).abs().max()))
    assert moved > 1e-4   # two AdamW steps moved the weights


def test_cli_evaluate_two_ranks(runs):
    """cli.evaluate on 2 gloo ranks over 5 synthetic pairs (batch 1): every
    rank's table equals the one-process table (5 pairs; the padded repeat
    dropped by identifier) within 1e-6 relative, and only rank 0 wrote
    the result files."""
    out = _job(runs, "cli_evaluate")
    ref = runs["refs"]["cli_evaluate"]
    assert ref["dset size"] == N_EVAL
    for r in range(2):
        table = out[r]["table"]
        assert table.keys() == ref.keys()
        for k, v in ref.items():
            assert abs(table[k] - v) <= 1e-6 * max(abs(v), 1e-30) or \
                (np.isnan(v) and np.isnan(table[k])), (r, k, table[k], v)
    assert out[0]["wrote"] and out[1]["wrote"] == []


# ---- the plumbing in one process ---------------------------------------------------


def test_init_distributed_without_a_launcher_does_nothing(monkeypatch):
    """No WORLD_SIZE and no arguments: no process group, one process, and
    every helper the identity."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    comm.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (comm.process_index(), comm.process_count()) == (0, 1)
    x = torch.arange(3.0)
    assert comm.all_reduce_sum(x) is x and comm.shard_rows(x) is x
    m = torch.nn.Linear(2, 2)
    assert comm.data_parallel(m) is m
    assert comm.local_device("cpu") == torch.device("cpu")
    comm.barrier()


def test_shard_rows_and_rank_rows_refuse_uneven_batches(monkeypatch):
    """At a world size of 2: shard_rows keeps rank 1's contiguous rows of a
    tensor and of a batch's tensors, and refuses 3 rows; the training
    CLI's loader keeps rank 1's rows of each global batch and refuses a
    global batch of 3."""
    monkeypatch.setattr(comm, "process_count", lambda: 2)
    monkeypatch.setattr(comm, "process_index", lambda: 1)
    monkeypatch.setattr(ttrain, "process_count", lambda: 2)
    monkeypatch.setattr(ttrain, "process_index", lambda: 1)
    x = torch.arange(8).reshape(4, 2)
    assert torch.equal(comm.shard_rows(x), x[2:])
    batch, _ = pairs(HW, n=4)
    rows = comm.shard_rows(batch)
    assert torch.equal(rows.image0, batch.image0[2:]) and torch.equal(rows.K1, batch.K1[2:])
    with pytest.raises(ValueError, match="does not split"):
        comm.shard_rows(torch.zeros(3))
    idx, b = ttrain._rank_rows(np.arange(10), 4)
    assert b == 2 and list(idx) == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="does not split"):
        ttrain._rank_rows(np.arange(10), 3)
