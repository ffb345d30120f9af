"""``parallel.launch`` takes the cards unless the caller asks for the
CPU: with no card and no device it raises before it spawns a rank."""

import pytest
import torch

from gsn_tpu_torch.parallel import launch
from gsn_tpu_torch.parallel import mesh


def _never(rank):
    raise AssertionError("a rank ran")


def test_launch_without_a_card_or_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(mesh.mp, "start_processes",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch(_never, 1)
    assert not spawned
