"""The port's training launcher (``python -m repro_torch.launch.train``)
against the JAX package's (``python -m repro.launch.train``), on the
CPU at the default architecture's smoke config in float32.

* Three steps print the reference launcher's ``[train]`` lines with the
  same ``T_virtual``, ``I`` and ``moved`` (the schedule is the same; the
  losses differ, as the two packages draw other random weights).
* A run stopped after step 1 and resumed from its checkpoint prints the
  uninterrupted run's lines and saves its step-2 checkpoint bit for bit.
* Without ``--device`` the launcher asks for the card and raises here.
"""
import re
import sys

import numpy as np
import pytest
import torch
from torch_zoo import hard_limit

from repro.launch import train as jtrain
from repro_torch.launch import train

__all__ = ["hard_limit"]

ARGS = ["--units", "6", "--seq", "16", "--workers", "5", "--unit-batch",
        "1"]
LINE = re.compile(r"\[train\] step (\d+): loss=(\S+) T_virtual=(\S+)s "
                  r"I=(\d+) moved=(\d+)")


def steps_of(out: str) -> dict:
    """{step: (loss, T_virtual, I, moved)} of the printed lines."""
    return {int(m[1]): tuple(m.groups()[1:]) for m in LINE.finditer(out)}


def run(capsys, *argv) -> str:
    train.main(["--device", "cpu", *ARGS, *argv])
    return capsys.readouterr().out


def test_three_steps_schedule_as_the_reference(capsys, monkeypatch):
    ours = steps_of(run(capsys, "--steps", "3"))
    monkeypatch.setattr(sys, "argv", ["train", *ARGS, "--steps", "3"])
    jtrain.main()
    want = steps_of(capsys.readouterr().out)
    assert sorted(ours) == sorted(want) == [0, 1, 2]
    for s in want:
        assert ours[s][1:] == want[s][1:], s
        assert np.isfinite(float(ours[s][0]))


def test_a_resumed_run_ends_on_the_uninterrupted_bits(capsys, tmp_path):
    straight = run(capsys, "--steps", "3", "--ckpt", str(tmp_path / "a"))
    first = run(capsys, "--steps", "2", "--ckpt", str(tmp_path / "b"))
    assert (tmp_path / "b" / "step_00000001").is_dir()
    resumed = run(capsys, "--steps", "3", "--ckpt", str(tmp_path / "b"))
    assert "[train] resumed from" in resumed
    assert sorted(steps_of(resumed)) == [2]
    assert {**steps_of(first), **steps_of(resumed)} == steps_of(straight)
    with np.load(tmp_path / "a" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "step_00000002" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].tobytes() == b[name].tobytes(), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
