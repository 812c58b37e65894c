"""A run with its timed path broken underneath comes out not correct: once
for each fault a one-card serving cell can have (a four-card exchange does
not exist here).  Tiny float32 cells, on the CPU; the harness's look for a
card is skipped by calling ``run_cell`` directly."""

from __future__ import annotations

import pytest
import torch

from chipbench import run
from conftest import add_tiny_cells


def _state_unchanged(real):
    """A decode step that returns its cache as it found it."""
    def step(cfg, params, cache, tokens, positions, ctx):
        before = _clone(cache)
        logits, _ = real(cfg, params, cache, tokens, positions, ctx)
        _restore(cache, before)
        return logits, cache
    return step


def _half_batch(real):
    """A prefill that computes the first half of the rows and hands their
    results to the other half."""
    def prefill(cfg, params, tokens, cache, ctx, **kw):
        h = tokens.shape[0] // 2
        return real(cfg, params, torch.cat([tokens[:h], tokens[:h]]), cache, ctx, **kw)
    return prefill


def _token_altered(real):
    """Row 0's token of each batch's second decode step is another one."""
    calls = {"n": 0}

    def step(cfg, params, cache, tokens, positions, ctx):
        logits, cache = real(cfg, params, cache, tokens, positions, ctx)
        calls["n"] += 1
        if calls["n"] % 5 == 2:   # the tiny traffic's G - 1 = 5 steps a batch
            logits = logits.clone()
            top = logits[0, -1].argmax()
            logits[0, -1, (top + 1) % logits.shape[-1]] = logits[0, -1, top] + 10.0
        return logits, cache
    return step


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _restore(tree, saved):
    for k, v in tree.items():
        _restore(v, saved[k]) if isinstance(v, dict) else v.copy_(saved[k])


FAULTS = {"state_unchanged": ("decode_step", _state_unchanged),
          "half_batch": ("prefill", _half_batch),
          "token_altered": ("decode_step", _token_altered)}


@pytest.mark.parametrize("family", [0, 1], ids=["dense", "hybrid"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(bench_copy, monkeypatch, family, fault):
    from repro_torch.models import transformer

    cell = add_tiny_cells(bench_copy)[family]
    sound = run.run_cell(cell, 21, 0.6, False, torch.device("cpu"), root=bench_copy)
    assert sound["correct"], sound["check"]
    name, make = FAULTS[fault]
    monkeypatch.setattr(transformer, name, make(getattr(transformer, name)))
    broken = run.run_cell(cell, 21, 0.6, False, torch.device("cpu"), root=bench_copy)
    assert not broken["correct"], broken["check"]
    assert broken["check"]["logit_gap"]["value"] > broken["check"]["logit_gap"]["limit"]
