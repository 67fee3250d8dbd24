"""PyTorch port vs JAX reference: the train step at the paper's learning
rate (``OptimConfig``'s default, 2e-5).

Every case of ``test_torch_train.TRAIN_CASES`` — each arm, dense and
chunked attention, remat none and block, float32 and bfloat16 — runs 3
steps against ``repro.train.step.build_train_step`` with
``test_torch_train``'s helpers and tolerances.  At this rate Adam's first
updates (≈ ±lr) are under half a bf16 ulp of the token table's entries, so
these cases show that a trained table moves as the reference's float32
one does.
"""
import pytest

from test_torch_train import OCFG, PAPER_LR, TRAIN_CASES, _check_train_steps
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode,dtype,attn,remat", TRAIN_CASES)
def test_train_step_matches_reference_at_the_papers_lr(mode, dtype, attn,
                                                       remat):
    """The same steps at lr 2e-5: the trained bf16 model's token table
    moves as the reference's float32 one does."""
    _check_train_steps(mode, dtype, attn, remat, dict(OCFG, lr=PAPER_LR))
