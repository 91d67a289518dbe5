"""A run with the timed path broken underneath comes out not correct:
an answer altered where it is produced (a coarse match, the fused t),
half of the batch left out (the other half copied from it), and a
request that returns the state of the one before unchanged. One card
holds the cells, so no exchange between chips can be left out."""

import dataclasses

import pytest
import torch

import far_tpu_torch.models.loftr as loftr
import far_tpu_torch.pipeline as pipeline
from helpers import CELLS, run_tiny

torch.set_num_threads(2)


def _tile(out, B):
    if isinstance(out, torch.Tensor):
        return out.repeat_interleave(B // out.shape[0], 0)
    if isinstance(out, tuple):
        return tuple(_tile(o, B) for o in out)
    if dataclasses.is_dataclass(out):
        return type(out)(**{f.name: _tile(getattr(out, f.name), B)
                            for f in dataclasses.fields(out)})
    return out


def break_request(monkeypatch, wrap):
    """Wrap the compiled FAR request."""
    build = pipeline.build_inference_fn
    monkeypatch.setattr(pipeline, "build_inference_fn", lambda model: wrap(build(model)))


def shifted_match(monkeypatch):
    """The coarse match answers the next cell of image 1."""
    real = loftr.coarse_match

    def shifted(*a, **k):
        i_ids, j_ids, *rest = real(*a, **k)
        return (i_ids, (j_ids + 1) % a[1].shape[1], *rest)
    monkeypatch.setattr(loftr, "coarse_match", shifted)


def half_batch(monkeypatch):
    def wrap(fn):
        def call(*args, uniforms, **kw):
            args = list(args)
            k = next(i for i, a in enumerate(args) if dataclasses.is_dataclass(a))
            B = args[k].image0.shape[0]
            args[k] = dataclasses.replace(args[k], **{
                f: getattr(args[k], f)[: B // 2] for f in ("image0", "image1", "K0", "K1")})
            args[k + 1:] = [a[: B // 2] for a in args[k + 1:]]
            return _tile(fn(*args, uniforms=[u[: B // 2] for u in uniforms], **kw), B)
        return call
    break_request(monkeypatch, wrap)


def stale_state(monkeypatch):
    """A replay that did not run: each request returns the previous
    request's output, its state unchanged."""
    def wrap(fn):
        last = []

        def call(*args, **kw):
            out = fn(*args, **kw)
            prev = last[0] if last else out
            last[:] = [out]
            return prev
        return call
    break_request(monkeypatch, wrap)


def moved_t(monkeypatch):
    def wrap(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            return dataclasses.replace(out, t=out.t + 0.01)
        return call
    break_request(monkeypatch, wrap)


@pytest.mark.parametrize("fault", [shifted_match, half_batch, stale_state, moved_t])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, res = run_tiny(capsys, cell)
    assert rc == 0
    assert res["correct"] is False, res["checks"]
