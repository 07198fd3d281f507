"""``TrainConfig``: the heterogeneous-training axis of an experiment, the
port of ``repro.hettrain.config``.

A frozen, JSON-lossless value that turns a Monte-Carlo experiment into a
*training study*: every scheme task becomes an epoch-assignment policy
over real gradients -- the unit-group engine computes the optimizer
trajectory (one canonical-order ``grad_sum`` per step, bit-identical
across policies by work conservation) while each policy's scheduler
moves virtual wall-clock (``repro_torch.hettrain.runner``).  One
``MCReport`` per grid point with the loss curve, per-step ``T_comp`` and
straggler-wait fractions in ``extra["training"]``.

``to_dict`` equals the reference's key for key: it is a hash input.  So
the device is no field of the config: the build methods and the runner take
``device=`` (default ``"cuda"``) as every entry point of the port does.

Knobs:

``steps``
    Optimizer steps per run.  Each step consumes ``spec.N`` fresh units
    (microbatches); ``spec.trials`` is the number of independent
    virtual-time realizations of the same trajectory.
``model`` / ``unit_batch`` / ``seq_len`` / ``vocab``
    Model preset (``MODEL_PRESETS``: reduced phi3-family transformers,
    float32, weights from the port's seeded init) and the
    microbatch-unit shape.
``data`` / ``data_seed`` / ``init_seed``
    ``"structured"`` is the learnable synthetic task (loss actually
    descends), ``"random"`` the i.i.d. token stream; unit content is a
    pure function of ``(data_seed, unit_id)``, which is what makes the
    gradient sum policy-independent.
``lr`` / ``weight_decay``
    AdamW hyperparameters.
``estimator`` / ``threshold_frac``
    The online-rate estimator (``core.estimator`` registry) the
    unknown-heterogeneity policies carry across steps, and the
    work-exchange cutting threshold.
``target_loss``
    When set, reports also carry ``wall_to_target`` / ``steps_to_target``
    (virtual wall-clock until the loss curve first reaches the target) --
    the fig_train panel's y-axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

from ..core.estimator import ESTIMATOR_REGISTRY, make_estimator
from ..device import DEFAULT_DEVICE, resolve_device

_DATAS = ("structured", "random")

# reduced same-family transformer presets (the configs' smoke shapes);
# dims only -- vocab comes from the ``vocab`` knob
MODEL_PRESETS: Dict[str, Dict[str, int]] = {
    "tiny": dict(n_layers=2, d_model=32, n_heads=2, head_dim=16,
                 n_kv_heads=2, d_ff=64),
    "small": dict(n_layers=2, d_model=64, n_heads=4, head_dim=16,
                  n_kv_heads=2, d_ff=128),
}

_BASE_ARCH = "phi3-mini-3.8b"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The heterogeneous-training axis as one hashable value."""

    steps: int = 8
    model: str = "tiny"
    unit_batch: int = 2
    seq_len: int = 16
    vocab: int = 128
    data: str = "structured"
    data_seed: int = 3
    init_seed: int = 0
    lr: float = 1e-2
    weight_decay: float = 0.0
    estimator: str = "cumulative"
    threshold_frac: float = 0.05
    target_loss: Optional[float] = None

    def __post_init__(self):
        if int(self.steps) <= 0:
            raise ValueError("steps must be positive")
        if self.model not in MODEL_PRESETS:
            raise ValueError(f"model must be one of "
                             f"{sorted(MODEL_PRESETS)}; got {self.model!r}")
        if (int(self.unit_batch) <= 0 or int(self.seq_len) <= 0
                or int(self.vocab) <= 1):
            raise ValueError("unit_batch/seq_len must be positive and "
                             "vocab > 1")
        if self.data not in _DATAS:
            raise ValueError(f"data must be one of {_DATAS}; "
                             f"got {self.data!r}")
        if float(self.lr) <= 0:
            raise ValueError("lr must be positive")
        if float(self.weight_decay) < 0:
            raise ValueError("weight_decay must be >= 0")
        if not 0.0 < float(self.threshold_frac):
            raise ValueError("threshold_frac must be positive")
        if self.target_loss is not None and float(self.target_loss) <= 0:
            raise ValueError("target_loss must be positive (or None)")
        # fail at construction, not mid-run: unknown estimator kinds
        # raise KeyError listing the registry
        make_estimator(self.estimator, 1)

    # -- build methods -------------------------------------------------------

    def model_config(self):
        """The reduced phi3-family ``ModelConfig`` this config trains."""
        from ..configs import get_config, smoke_config
        return dataclasses.replace(
            smoke_config(get_config(_BASE_ARCH)), dtype="float32",
            vocab_size=int(self.vocab), **MODEL_PRESETS[self.model])

    def build_model(self, device=DEFAULT_DEVICE):
        """(model, params): the reduced transformer this config trains.
        The port's init draws its weights from ``init_seed`` on the host
        and they are moved to ``device``: the same weights on every
        device, as the reference's key draws the same weights anywhere
        (a card's generator would draw others)."""
        from ..models import build_model
        from ..optim.adamw import tree_map
        dev = resolve_device(device)
        model = build_model(self.model_config())
        params = model.init(int(self.init_seed), "cpu")
        return model, tree_map(lambda p: p.to(dev), params)

    def build_store(self):
        from ..data.pipeline import UnitStore
        return UnitStore(unit_batch=int(self.unit_batch),
                         seq_len=int(self.seq_len), vocab=int(self.vocab),
                         seed=int(self.data_seed),
                         structured=(self.data == "structured"))

    def build_optimizer(self):
        from ..optim import AdamW
        return AdamW(lr=float(self.lr),
                     weight_decay=float(self.weight_decay))

    # -- serialization (every knob appears: the dict is the hash input) -----

    def to_dict(self) -> Dict[str, Any]:
        return {
            "steps": int(self.steps),
            "model": self.model,
            "unit_batch": int(self.unit_batch),
            "seq_len": int(self.seq_len),
            "vocab": int(self.vocab),
            "data": self.data,
            "data_seed": int(self.data_seed),
            "init_seed": int(self.init_seed),
            "lr": float(self.lr),
            "weight_decay": float(self.weight_decay),
            "estimator": self.estimator,
            "threshold_frac": float(self.threshold_frac),
            "target_loss": (None if self.target_loss is None
                            else float(self.target_loss)),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TrainConfig":
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - allowed
        if unknown:
            raise KeyError(f"unknown training key(s) {sorted(unknown)}; "
                           f"allowed {sorted(allowed)} (registered "
                           f"estimators: {ESTIMATOR_REGISTRY.names()})")
        return cls(**dict(d))


__all__ = ["TrainConfig", "MODEL_PRESETS"]
