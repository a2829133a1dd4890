"""A run with the timed path broken underneath comes out not correct; a
sound run comes out correct. Each cell drives the compiled model
(`CompiledModel.__call__`) under its entry, so the faults are planted
there: a step that returns its state unchanged (the first output again),
half of the batch left out, one answer altered where it is produced. (No
cell runs across chips: there is no exchange to leave out.)"""

import pytest
import torch

from conftest import TINY, run_tiny, tiny_cell


def _stale():
    first = {}

    def fault(outs):
        if not first:
            first.update({k: v.clone() for k, v in outs.items()})
        return dict(first)

    return fault


def _half(outs):
    out = {}
    for k, v in outs.items():
        v = v.clone()
        v[v.shape[0] // 2:] = 0 if v.shape[0] > 1 else v[:1] * 0
        out[k] = v
    return out


def _altered(outs):
    out = {}
    for k, v in outs.items():
        v = v.clone()
        v[0, : max(v.shape[1] // 4, 1), : max(v.shape[2] // 4, 1)] += 0.25
        out[k] = v
    return out


FAULTS = {"stale": _stale, "half": lambda: _half, "altered": lambda: _altered}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(cell):
    r = run_tiny(tiny_cell(cell))
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    from shadernn_tpu_torch.engine.compile import CompiledModel

    real = CompiledModel.__call__
    plant = FAULTS[fault]()

    def broken(self, inputs):
        return plant(real(self, inputs))

    monkeypatch.setattr(CompiledModel, "__call__", broken)
    r = run_tiny(tiny_cell(cell))
    assert not r["correct"], (fault, r["check"])
    # the numbers that failed are shown beside their limits
    assert any(c["value"] > c["limit"] for c in r["check"].values())


def test_a_frame_that_never_comes_is_failed(monkeypatch):
    from shadernn_tpu_torch.engine import streaming

    real = streaming.StreamingEngine._drain_one
    calls = []

    def lose_one(self, batch):
        calls.append(1)
        if len(calls) == 3:
            batch.frames = batch.frames[1:]
        return real(self, batch)

    monkeypatch.setattr(streaming.StreamingEngine, "_drain_one", lose_one)
    cell = tiny_cell("espcn-540p-serve")
    cell.traffic = dict(cell.traffic, preroll_s=0.0)
    r = run_tiny(cell, trace=True)
    assert r["failed"] == 1 and not r["correct"]
    assert r["metrics"]["serve.latency_p95_ms"]["value"] < float("inf")
    lat = torch.tensor([r["metrics"]["serve.latency_p50_ms"]["value"]])
    assert torch.isfinite(lat).all()
