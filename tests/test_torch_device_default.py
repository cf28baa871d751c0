"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: ``StereoFrontend``, ``MonoFrontend``, ``StreamPool`` and
``SyntheticSequence`` default to ``cuda`` and, without a card, raise instead of falling back.

The no-card case is made here by patching ``torch.cuda.is_available``
inside each test, so it holds on any machine; the card's own default is
checked in ``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models.frontend import StereoFrontend
from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
from scavislam_tpu_torch.parallel.stream_pool import StreamPool

CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)

ENTRY_POINTS = {
    "StereoFrontend": lambda **kw: StereoFrontend(CAM, **kw),
    "MonoFrontend": lambda **kw: MonoFrontend(CAM, **kw),
    "StreamPool": lambda **kw: StreamPool(CAM, n_streams=2, **kw),
    "SyntheticSequence": lambda **kw: SyntheticSequence(CAM, 1, **kw),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_card_raises_naming_cpu(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_on_request(no_card, name):
    obj = ENTRY_POINTS[name](device="cpu")
    assert obj.device == torch.device("cpu")


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device()
