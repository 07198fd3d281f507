"""The port's training studies (``repro_torch.hettrain.config`` and
``runner``) held against the JAX package's, on the CPU.

``run_training_grid`` runs for the seven ported schemes at the ``tiny``
preset (float32), 3 steps of 8 units, on 2 grid points x 2 trials.  The
JAX side trains from the port's weights: its ``TrainConfig.build_model``
is patched to return them, carried as numpy arrays (as
``tests/test_torch_hettrain.py`` carries them), instead of drawing its
own.  The JAX package computes one trajectory whatever the scheme (its
loss curves are byte-equal across schemes, pinned by its own
``tests/test_hettrain.py``), so the JAX side's trajectory is computed
once and handed to every scheme's run; the port computes its own for
every scheme.

Tolerances: every field of each report but the loss curve is host numpy
or a count and is held **exactly** (times, epochs, ``n_comm``, straggler
wait, refetch tokens, the engine's stats, ``steps_to_target``); the loss
curve and the final loss at rtol and atol 1e-4, as the gradient engine
is held.  Within the port the curves are **bitwise** equal across
schemes.  ``TrainConfig.to_dict`` / ``from_dict`` equal the reference's
key for key: the dict is a hash input.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.types import HetSpec as JaxHetSpec
from repro.hettrain import config as jax_config
from repro.hettrain import runner as jax_runner
from repro.models import build_model as jax_build_model
from repro_torch.core import HetSpec
from repro_torch.hettrain import (MODEL_PRESETS, TrainConfig,
                                  compute_trajectory, run_training_grid)

SCHEMES = ("oracle", "fixed", "uniform", "mds", "work_exchange",
           "work_exchange_unknown", "gradient_coded")
TRAIN = TrainConfig(model="tiny", steps=3, target_loss=4.8)
N_STEP, TRIALS, SEED = 8, 2, 5
POINTS = ([1.0, 4.0, 2.0, 8.0], [3.0, 3.5, 1.0, 6.0])


def test_train_config_dict_is_the_reference():
    assert MODEL_PRESETS == jax_config.MODEL_PRESETS
    for cfg in (TrainConfig(), TrainConfig(steps=5, model="small", lr=3e-3,
                                           estimator="ema", target_loss=2.5,
                                           data="random", weight_decay=0.1)):
        d = cfg.to_dict()
        ref = jax_config.TrainConfig.from_dict(d)
        assert ref.to_dict() == d and list(ref.to_dict()) == list(d)
        assert TrainConfig.from_dict(ref.to_dict()) == cfg
    with pytest.raises(KeyError, match="typo"):
        TrainConfig.from_dict({**TrainConfig().to_dict(), "typo": 1})
    with pytest.raises(KeyError, match="psychic"):
        TrainConfig(estimator="psychic")
    with pytest.raises(ValueError):
        TrainConfig(model="gpt-7t")


@pytest.fixture(scope="module")
def grids():
    model, params = TRAIN.build_model("cpu")
    drawn = jax.tree.map(lambda x: x.numpy(), params)
    jm = jax_build_model(dataclasses.replace(
        jax_smoke_config(jax_get_config("phi3-mini-3.8b")), dtype="float32",
        vocab_size=TRAIN.vocab, **MODEL_PRESETS[TRAIN.model]))
    jtrain = jax_config.TrainConfig.from_dict(TRAIN.to_dict())
    traj = {}

    def trajectory_once(training, N):
        if "run" not in traj:
            traj["run"] = compute_jax(training, N)
        return traj["run"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_config.TrainConfig, "build_model",
                   lambda self: (jm, jax.tree.map(jnp.asarray, drawn)))
        compute_jax = jax_runner.compute_trajectory
        mp.setattr(jax_runner, "compute_trajectory", trajectory_once)
        ref = {name: jax_runner.run_training_grid(
                   name, {}, [JaxHetSpec(np.array(p)) for p in POINTS],
                   jtrain, N_STEP, TRIALS, SEED)
               for name in SCHEMES}
    ours = {name: run_training_grid(
                name, {}, [HetSpec(np.array(p)) for p in POINTS], TRAIN,
                N_STEP, TRIALS, SEED, device="cpu")
            for name in SCHEMES}
    return ours, ref


def split(report):
    """(the report's dict without its losses, the loss curve)."""
    d = copy.deepcopy(report.to_dict())
    info = d["extra"]["training"]
    return d, np.array(info.pop("loss_curve") + [info.pop("final_loss")])


@pytest.mark.parametrize("name", SCHEMES)
def test_run_training_grid_is_the_reference(grids, name):
    ours, ref = grids
    assert len(ours[name]) == len(ref[name]) == len(POINTS)
    for a, b in zip(ours[name], ref[name]):
        da, curve = split(a)
        db, jcurve = split(b)
        assert da == db
        np.testing.assert_allclose(curve, jcurve, rtol=1e-4, atol=1e-4)


def test_loss_curves_are_bitwise_across_schemes(grids):
    ours, _ = grids
    curves = {name: [r.extra["training"]["loss_curve"] for r in reps]
              for name, reps in ours.items()}
    first = curves[SCHEMES[0]][0]
    assert all(c == first for cs in curves.values() for c in cs)
    # the loss falls on the structured task and the target is reached
    assert first[-1] < first[0]
    info = ours["work_exchange"][0].extra["training"]
    assert info["steps_to_target"] >= 1 and info["wall_to_target"] > 0


def test_compute_trajectory_trains_from_the_seed():
    a, pa, eng = compute_trajectory(TRAIN, 4, device="cpu")
    b, pb, _ = compute_trajectory(TRAIN, 4, device="cpu")
    assert a == b and len(a) == TRAIN.steps
    assert eng.stats() == {"dispatches": TRAIN.steps,
                           "units": 4 * TRAIN.steps, "bucket_sizes": [4]}
