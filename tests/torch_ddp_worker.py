"""One rank of tests/test_torch_distributed.py's gloo runs on the CPU.

    python tests/torch_ddp_worker.py <work_dir> <job> [<job> ...]

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_RANK`` set as ``torch.distributed.run`` sets them. The rank joins
the group through ``far_tpu_torch.parallel.comm.init_distributed``, reads
the inputs the test wrote (``<work_dir>/inputs.pt``), runs each job and
saves what it saw to ``<work_dir>/<job>.rank<r>.pt``. A job that raises
writes its traceback to ``<job>.rank<r>.err`` and ends the process, so
the other rank's next collective fails instead of waiting. The job
``world1`` runs one step without a process group, then joins a group of
one and runs it again under DDP. Imports torch and far_tpu_torch only.
"""

import contextlib
import dataclasses
import math
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)

from far_tpu_torch.parallel import comm  # noqa: E402
from far_tpu_torch.solvers.types import PoseEstimate  # noqa: E402


def fixed_solver(kpts0, kpts1, K0, K1, valid, *args, **kwargs) -> PoseEstimate:
    """A solver result that depends on each pair alone (its count of valid
    correspondences), not on the batch it sits in: RANSAC on a random
    model's matches picks among near-ties, and a batch's draws depend on
    its composition."""
    B, dev = kpts0.shape[0], kpts0.device
    c, s = math.cos(0.2), math.sin(0.2)
    R = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], device=dev).expand(B, 3, 3)
    t = torch.tensor([0.3, -0.1, 0.9], device=dev).expand(B, 3)
    n = valid.float().sum(-1)
    return PoseEstimate(E=torch.zeros(B, 3, 3, device=dev), R=R, t=t, inliers=valid,
                        num_inliers=torch.floor(0.5 * n), num_tight=torch.floor(0.1 * n),
                        num_ultra_tight=torch.zeros(B, device=dev),
                        success=torch.ones(B, dtype=torch.bool, device=dev))


def stub_solvers():
    """``fixed_solver`` in place of every module's ``estimate_pose``."""
    import far_tpu_torch.pipeline as pipeline
    import far_tpu_torch.train.family_trainers as family
    import far_tpu_torch.train.trainer as trainer

    for mod in (pipeline, family, trainer):
        mod.estimate_pose = fixed_solver


def params_and_stats(module: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def sgd_steps(trainer, batch, n: int = 1, f64: bool = False) -> dict:
    """``n`` SGD(lr=1) steps on this rank's rows of the global batch: each
    step's metrics, the state after each. With ``f64`` the model is made
    float64 and the steps run under ``float64_compute``: the float32 code's
    arithmetic without float32's rounding, which the ill-conditioned early
    convolutions of every family amplify to ~1e-5 of a gradient."""
    from far_tpu_torch.utils.float64 import float64_compute

    if f64:
        trainer.model.double()
        batch = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name).double() for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)
            and getattr(batch, f.name).is_floating_point()})
    params = trainer.parameters() if callable(getattr(trainer, "parameters", None)) \
        else list(trainer.model.parameters())
    trainer.optimizer = torch.optim.SGD(params, lr=1.0)
    out = {"metrics": [], "states": [], "extra": []}
    with float64_compute() if f64 else contextlib.nullcontext():
        for _ in range(n):
            out["metrics"].append(trainer.step(comm.shard_rows(batch)))
            out["states"].append(params_and_stats(trainer.model))
            out["extra"].append({k: p.detach().clone()
                                 for k, p in getattr(trainer, "extra", {}).items()})
    return out


# ---- jobs -----------------------------------------------------------------------


def job_collectives(inp: dict) -> dict:
    """The differentiable sum, ``mean_scalars`` and ``all_gather_metrics``
    with identifiers over a padded shard of an odd pair count."""
    from far_tpu_torch.data.sampler import sequential_indices
    from far_tpu_torch.eval.metrics import aggregate_metrics
    from far_tpu_torch.train.validation import gather_pair_metrics

    r, w = comm.process_index(), comm.process_count()
    x = torch.arange(4, dtype=torch.float64) + 10 * r
    x.requires_grad_(True)
    y = comm.all_reduce_sum(x * x)
    (y * (r + 1)).sum().backward()
    scalars = comm.mean_scalars({"a": torch.tensor(float(r)), "b": torch.tensor(2.0 + r)})

    n = inp["n_pairs"]
    idx = sequential_indices(n, rank=r, world_size=w)
    # a rotation error that tells the ranks' copies of a repeated pair apart
    acc = {"identifiers": [f"scene#pair{i}" for i in idx],
           "R_errs": [i + 0.25 * r for i in idx], "t_errs": [0.5 * i for i in idx],
           "t_errs_abs": [0.1 * i for i in idx], "successful_fits": [1.0] * len(idx),
           "epi_errs": [np.where(np.arange(4) <= i, 1e-5 * (i + 1), np.nan).astype(np.float32)
                        for i in idx]}
    raw = comm.all_gather_metrics({
        "identifiers": comm.encode_strings(acc["identifiers"]),
        "f32": np.asarray(idx, np.float32), "f64": np.asarray(idx, np.float64),
        "i64": np.asarray(idx), "flags": np.asarray(idx) % 2 == 0,
        "scalar": np.float32(r)})
    pairs = gather_pair_metrics(acc)
    return {"y": y.detach(), "grad": x.grad, "scalars": scalars, "raw": raw,
            "pairs": pairs, "table": aggregate_metrics(pairs)}


def job_bn(inp: dict) -> dict:
    """``bn`` in train mode on this rank's rows of a global batch."""
    from far_tpu_torch.models.backbone import bn

    m = torch.nn.BatchNorm2d(inp["bn_x"].shape[1])
    m.load_state_dict(inp["bn_state"])
    x = comm.shard_rows(inp["bn_x"]).clone().requires_grad_(True)
    y = bn(x, m)
    (y * comm.shard_rows(inp["bn_g"])).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": m.weight.grad, "db": m.bias.grad,
            "running_mean": m.running_mean, "running_var": m.running_var}


def _far_trainer(inp: dict, **over):
    from far_tpu_torch.train.trainer import Trainer

    trainer = Trainer(dataclasses.replace(inp["far_cfg"], **over), device="cpu")
    trainer.model.load_state_dict(inp["far_sd"])
    return trainer


def job_far(inp: dict) -> dict:
    """Two SGD(1) FAR steps on the global batch in float32, two in float64."""
    return {"f32": sgd_steps(_far_trainer(inp), inp["far_batch"], 2),
            "f64": sgd_steps(_far_trainer(inp), inp["far_batch"], 2, f64=True)}


def job_remat(inp: dict) -> dict:
    """One SGD(1) FAR step under each remat setting."""
    return {str(remat): sgd_steps(_far_trainer(inp, remat=remat), inp["far_batch"])
            for remat in (False, "full", "selective")}


def _family(inp: dict, family: str, **kw):
    from far_tpu_torch.models.sixdreg import MapfreeRegression
    from far_tpu_torch.models.vitess import ViTEss
    from far_tpu_torch.train import family_trainers as fam

    cfg, sd, batch = inp[f"{family}_cfg"], inp[f"{family}_sd"], inp[f"{family}_batch"]
    if family == "vitess":
        trainer = fam.ViTEssTrainer(cfg, device="cpu")
    else:
        trainer = fam.SixDRegTrainer(cfg, device="cpu", **kw)
    assert isinstance(trainer.model, (ViTEss, MapfreeRegression))
    trainer.model.load_state_dict(sd)
    return sgd_steps(trainer, batch, 2, f64=True)


def job_vitess(inp: dict) -> dict:
    return _family(inp, "vitess")


def job_sixdreg1(inp: dict) -> dict:
    return _family(inp, "sixdreg", lam=1.0)


def job_sixdreg0(inp: dict) -> dict:
    return _family(inp, "sixdreg", lam=0.0)


def job_cli_train(inp: dict) -> dict:
    """``cli.train`` for two steps, then again with ``--resume``, the
    float32 model computing in float64 (``float64_compute``): AdamW's
    first steps are about lr times the gradient's sign, so float32's
    rounding of a gradient near 0 would move a weight by up to lr."""
    from far_tpu_torch.cli import train
    from far_tpu_torch.utils.float64 import float64_compute

    with float64_compute():
        trainer = train.main(inp["train_argv"])
        again = train.main(inp["train_argv"] + ["--resume"])
    return {"step_count": trainer.step_count, "resumed_step_count": again.step_count,
            "state": params_and_stats(trainer.model)}


def job_cli_evaluate(inp: dict) -> dict:
    from far_tpu_torch.cli import evaluate

    out_dir = Path(inp["evaluate_argv"][inp["evaluate_argv"].index("--out_dir") + 1])
    rank_dir = out_dir / f"rank{comm.process_index()}"
    argv = list(inp["evaluate_argv"])
    argv[argv.index("--out_dir") + 1] = str(rank_dir)
    table = evaluate.main(argv)
    return {"table": table, "wrote": sorted(p.name for p in rank_dir.glob("*"))
            if rank_dir.exists() else []}


def job_world1(inp: dict) -> dict:
    """One FAR step without a process group, then the same step from the
    same weights in a group of one (DDP, gloo)."""
    plain = sgd_steps(_far_trainer(inp), inp["far_batch"])
    comm.init_distributed(device="cpu")
    assert comm.process_count() == 1 and torch.distributed.is_initialized()
    trainer = _far_trainer(inp)
    grouped = sgd_steps(trainer, inp["far_batch"])
    return {"plain": plain, "grouped": grouped,
            "ddp": type(trainer._ddp).__name__}


def main() -> None:
    work, jobs = Path(sys.argv[1]), sys.argv[2:]
    stub_solvers()
    inp = torch.load(work / "inputs.pt", weights_only=False)
    rank = int(os.environ["RANK"])
    if jobs != ["world1"]:
        comm.init_distributed(device="cpu")
        assert comm.process_count() == int(os.environ["WORLD_SIZE"])
        assert torch.distributed.get_backend() == "gloo"
    for job in jobs:
        try:
            out = globals()[f"job_{job}"](inp)
        except Exception:
            (work / f"{job}.rank{rank}.err").write_text(traceback.format_exc())
            sys.stderr.write(traceback.format_exc())
            sys.stderr.flush()
            os._exit(1)
        torch.save(out, work / f"{job}.rank{rank}.pt")
    comm.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
