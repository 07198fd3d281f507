"""The differentiable collectives of ``repro_torch.distributed.collectives``
on 4 gloo ranks, a (data 2, model 2) mesh, in float64.

Each is used as the model path uses it (``torch_train_ranks
.collectives_grad_rank``), and each rank's gradients of its local inputs
are held against the same computation done whole on one rank, cut to the
rank's blocks, under ``train.loop``'s convention (each data coordinate's
loss counted once): the FSDP gather over 'data', the sequence-parallel
gather and reduce-scatter, the all-reduce of a partial output, the entry
of a replicated activation, the vocab gather, the all-to-all and the
mean over every rank.  The vocab gather's backward is this rank's slice
of the cotangent, not a reduce-scatter (which would double it here).
The scatter path at model > 1, which serving's decode takes, refuses a
backward (its collectives have none).
"""
from pathlib import Path

import pytest
import torch

from repro_torch.launch.mesh import spawn

import torch_train_ranks as ranks

LIMIT_S = 90
CASES = ("fsdp_gather", "sp_gather", "sp_scatter", "reduce_partial",
         "enter", "exchange", "mean_over_all")


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_grad")
    spawn(ranks.collectives_grad_rank, 4, (str(out),), timeout_s=LIMIT_S,
          store_dir=str(out))
    return [torch.load(Path(out) / f"collectives-r{r}.pt",
                       weights_only=False) for r in range(4)]


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_the_whole_computation(recs, case):
    for rec in recs:
        got, want, _ = rec[case]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_the_backward_collectives_are_tallied(recs):
    """The FSDP gather's forward all-gather and its backward
    reduce-scatter each count once, over the 2 data ranks."""
    for rec in recs:
        counts = rec["fsdp_gather"][2]
        assert counts["all_gather/2"]["calls"] == 1, counts
        assert counts["reduce_scatter/2"]["calls"] == 1, counts


def test_the_vocab_gather_backward_is_a_slice(recs):
    for rec in recs:
        grad, cot_slice = rec["vocab_slice"]
        assert torch.equal(grad, cot_slice), rec["coord"]


def test_the_scatter_path_at_model_two_refuses_a_backward(recs):
    for rec in recs:
        assert "serves only" in rec["scatter_refused"], rec["coord"]
