"""TrainingGeometry arithmetic + resume-position math (ref: tests/test_trainer.py:88-205)."""

import math

import pytest

from ssi_jax.train.geometry import TrainingGeometry
from tests.helpers import make_cfg


class FakeLoader:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def geometry_cfg(batch_size=4, grad_accum=4, max_steps=100):
    return make_cfg(
        {
            "data": {"train": {"dataloader": {"batch_size": batch_size}}},
            "gradient_accumulation_steps": grad_accum,
            "max_steps": max_steps,
        }
    )


def test_basic_arithmetic():
    geo = TrainingGeometry.from_config(geometry_cfg(grad_accum=4, max_steps=100), FakeLoader(100), world_size=1)
    assert geo.batches_per_epoch == 100
    assert geo.steps_per_epoch == 25
    assert geo.usable_batches == 100
    assert geo.n_epochs == math.ceil(100 / 25) == 4


def test_remainder_batches_discarded():
    geo = TrainingGeometry.from_config(geometry_cfg(grad_accum=4, max_steps=10), FakeLoader(103), world_size=1)
    assert geo.steps_per_epoch == 25
    assert geo.usable_batches == 100  # 3 remainder batches dropped per epoch


def test_raises_when_loader_smaller_than_accum():
    with pytest.raises(ValueError):
        TrainingGeometry.from_config(geometry_cfg(grad_accum=8, max_steps=10), FakeLoader(5), world_size=1)


def test_n_epochs_ceil():
    geo = TrainingGeometry.from_config(geometry_cfg(grad_accum=2, max_steps=7), FakeLoader(10), world_size=1)
    assert geo.steps_per_epoch == 5
    assert geo.n_epochs == 2  # ceil(7/5)


@pytest.mark.parametrize(
    "global_step,steps_per_epoch,grad_accum,expected_epoch,expected_skip",
    [
        (0, 25, 4, 0, 0),
        (10, 25, 4, 0, 40),
        (25, 25, 4, 1, 0),
        (30, 25, 4, 1, 20),
        (99, 25, 4, 3, 96),
    ],
)
def test_resume_position_math(global_step, steps_per_epoch, grad_accum, expected_epoch, expected_skip):
    """Mid-epoch resume arithmetic (ref: ssi/trainer.py:345-346; tests/test_checkpoint.py:203-240)."""
    epoch = global_step // steps_per_epoch
    batches_to_skip = (global_step % steps_per_epoch) * grad_accum
    assert epoch == expected_epoch
    assert batches_to_skip == expected_skip
