"""The rest of a run, without the look for a card, with the timed path
broken underneath: ``correct`` comes out false, once for each fault the
cell can have.  A generation cell: an answer altered where it is produced
(the synthesis, K3's entry, leaves one image of the batch unwritten).  A
training cell: a step that returns its state unchanged (no optimizer step
lands), and half of the batch left out with the mean taken over the rest.
The small configurations run in float32, where the sound path reads
rounding; the cell's own limits judge."""

import time

import pytest
import torch

from perfbench import run
from perfbench.drivers import generation, training

from _small import small_cell

INFO = {"platform": "cpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}


def run_cell(cell, driver=generation, **kw):
    rec = driver.run(cell, 77, 0.2, False, torch.device("cpu"), time.perf_counter(), **kw)
    return run.result(cell, rec, False, INFO)


def test_altered_answer_is_not_correct(monkeypatch):
    cell = small_cell("gen.map3dbn512l.b8")
    assert run_cell(cell)["correct"]  # the sound path passes the cell's own limits
    from threedhumangan_tpu_torch.models import generator as G

    fused = G.fused_synthesis

    def misrouted(*a, **k):
        out = fused(*a, **k)
        return torch.cat([out[:1], torch.zeros_like(out[1:2]), out[2:]]) if len(out) > 1 \
            else torch.zeros_like(out)

    monkeypatch.setattr(G, "fused_synthesis", misrouted)
    res = run_cell(cell)
    assert not res["correct"]
    assert res["checks"]["rgb_rel_l2"]["value"] > res["checks"]["rgb_rel_l2"]["limit"]


@pytest.fixture(scope="module")
def train_cell():
    return small_cell("train.map3dbn.b32", use_mixed_precision=False)


def test_training_sound_path_is_correct(train_cell):
    res = run_cell(train_cell, training)
    assert res["correct"], res["checks"]


def test_training_state_unchanged_is_not_correct(train_cell, monkeypatch):
    from threedhumangan_tpu_torch.trainers import phase_trainer

    monkeypatch.setattr(phase_trainer, "adam_step", lambda *a, **k: None)
    res = run_cell(train_cell, training)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > res["checks"]["change_gap"]["limit"]


def test_training_half_batch_is_not_correct(train_cell):
    res = run_cell(train_cell, training, fault="half")
    assert not res["correct"], res["checks"]
