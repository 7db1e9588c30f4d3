"""Gradients of the training loss for the SSM, hybrid and encoder-decoder
families: ``test_torch_train_loss.py``'s tests, with its tolerances, on
reduced Jamba (Mamba-2, attention, MoE under ``capacity`` and dense
layers), Whisper and mamba2-370m over 512 positions (16 chunks: the
per-chunk path whose chunks are recomputed in the backward).
"""
import pytest

from test_torch_train_loss import (  # noqa: F401  (collected here too)
    _ids, make_case, test_loss_fn_gradients_match_reference,
    test_remat_equals_no_remat)

CASES = [("jamba-v0.1-52b", "capacity", "onehot", 1, 64),
         ("whisper-base", None, "onehot", 2, 6),
         ("mamba2-370m", None, "onehot", 1, 512)]

case = pytest.fixture(scope="module", params=CASES, ids=_ids)(make_case)
