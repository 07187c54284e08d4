"""The port's token pipeline, checkpoints and training launcher on the CPU.

* ``data``: ``batch_for_step`` gives the reference's arrays for several
  (config, step) pairs, host shards included; ``TokenPipeline`` yields the
  steps in order from any ``start_step`` (restart-exact); ``DataConfig``'s
  fields and defaults are the reference's.
* ``train.checkpoint``: keep-K, ``.tmp`` directories never listed, restore
  bit-equal on the CPU (parameters, both moments, the step, metadata),
  training 4 steps equal to training 2, saving, restoring into a fresh
  ``Trainer`` and training 2 more (bit for bit), and a missing or misshapen
  array refused.
* ``launch/train.py --device cpu`` prints the reference launcher's lines and
  ``--resume`` continues at the saved step.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import batch_for_step as jbatch_for_step

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline, batch_for_step
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.train import (AdamWConfig, CheckpointManager, TrainConfig,
                               Trainer)

DATA_CASES = [dict(vocab_size=512, seq_len=32, global_batch=4, seed=3),
              dict(vocab_size=92416, seq_len=128, global_batch=8, seed=0,
                   n_hosts=2, host_index=1),
              dict(vocab_size=64, seq_len=7, global_batch=6, seed=11,
                   n_hosts=3, host_index=2, zipf_a=1.1, motif_len=3,
                   n_motifs=5)]


@pytest.mark.parametrize("case", range(len(DATA_CASES)))
def test_batch_for_step_equals_the_reference(case):
    kw = DATA_CASES[case]
    for step in (0, 1, 17, 10_000):
        got = batch_for_step(DataConfig(**kw), step)
        want = jbatch_for_step(JDataConfig(**kw), step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])


def test_data_config_fields_equal():
    got = [(f.name, f.default) for f in dataclasses.fields(DataConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JDataConfig)]
    assert got == want
    assert DataConfig(1, 2, 6, n_hosts=3).host_batch == 2


@pytest.mark.parametrize("start", [0, 5])
def test_pipeline_order_and_restart(start):
    cfg = DataConfig(vocab_size=128, seq_len=8, global_batch=2, seed=4)
    pipe = TokenPipeline(cfg, start_step=start)
    jpipe = JTokenPipeline(JDataConfig(**dataclasses.asdict(cfg)),
                           start_step=start)
    for i in range(4):
        b, jb = next(pipe), next(jpipe)
        assert np.array_equal(b["tokens"],
                              batch_for_step(cfg, start + i)["tokens"])
        assert np.array_equal(b["labels"], jb["labels"])
        assert pipe.step == start + i + 1
    pipe.close()
    jpipe.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trainer(ck=None, seed=0):
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=20),
                     log_every=1000, checkpoint_every=10_000)
    return Trainer(cfg, tc, init_params(cfg, seed=seed, device="cpu"),
                   ckpt_manager=ck, device="cpu")


def _data(cfg, start=0):
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4), start_step=start)


def _run(tr, n, start=0):
    data = _data(tr.cfg, start)
    hist = tr.run(data, n, log_fn=lambda s: None)
    data.close()
    return hist


def test_keep_k_and_tmp_dirs(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    named = {"w": torch.ones(2, 2)}
    for s in (1, 2, 3):
        ck.save(s, named, blocking=True)
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    os.makedirs(tmp_path / "step_9.tmp")       # a save cut short
    assert ck.steps() == [2, 3]
    ck.save(4, named)                          # background write
    ck.wait()
    assert ck.steps() == [3, 4]
    assert not any(p.name.endswith(".tmp") and p.name != "step_9.tmp"
                   for p in tmp_path.iterdir())


def test_restore_bit_equal(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    tr = _trainer(ck)
    _run(tr, 3)
    step = ck.latest_step()
    assert step == 3
    named, opt, meta = ck.restore(step, tr.named, tr.opt_state, device="cpu")
    assert meta["step"] == 3 and meta["arch"] == tr.cfg.name
    assert named.keys() == tr.named.keys()
    for k, p in tr.named.items():
        assert named[k].dtype == p.dtype and torch.equal(named[k], p.detach())
        assert torch.equal(opt.mu[k], tr.opt_state.mu[k])
        assert torch.equal(opt.nu[k], tr.opt_state.nu[k])
    assert opt.step.dtype == torch.int32 and int(opt.step) == 3


def test_restart_is_bit_exact(tmp_path):
    """4 steps == 2 steps, save, restore into a fresh Trainer, 2 steps."""
    whole = _trainer()
    want = _run(whole, 4)
    ck = CheckpointManager(str(tmp_path))
    first = _trainer(ck)
    _run(first, 2)
    fresh = _trainer(ck, seed=5)               # other weights until restored
    meta = fresh.restore(ck.latest_step())
    fresh.step = meta["step"]
    got = _run(fresh, 2, start=meta["step"])
    assert [h["loss"] for h in got] == [h["loss"] for h in want[2:]]
    for k, p in whole.named.items():
        assert torch.equal(p, fresh.named[k])
        assert torch.equal(whole.opt_state.mu[k], fresh.opt_state.mu[k])


def test_missing_or_misshapen_array_raises(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"w": torch.ones(2, 3), "b": torch.ones(3)}, blocking=True)
    with pytest.raises(KeyError, match="missing array: x"):
        ck.restore(1, {"w": torch.ones(2, 3), "x": torch.ones(1)},
                   device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"w": torch.ones(3, 2)}, device="cpu")
    named, _, _ = ck.restore(1, {"w": torch.zeros(2, 3, dtype=torch.bfloat16)},
                             device="cpu")
    assert named["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

ARGS = ["--arch", "codeqwen1.5-7b", "--reduced", "--batch", "4", "--seq",
        "32", "--device", "cpu"]


def test_launcher_trains_and_resumes(capsys, tmp_path):
    launch_train.main(ARGS + ["--steps", "4", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=codeqwen1.5-7b-reduced params=" in out
    assert "step     0 loss " in out and "done: loss " in out
    assert "stragglers flagged: " in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    launch_train.main(ARGS + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                              "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4 (arch=codeqwen1.5-7b-reduced)" in out
    assert "done: loss " in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
