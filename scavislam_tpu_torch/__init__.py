"""scavislam_tpu_torch — the PyTorch + CUDA port of scavislam_tpu.

The JAX package ``scavislam_tpu`` is the reference: every module here mirrors
its twin's layout and public names (``core/ ops/ models/ io/ utils/``) and is
held against it by the ``tests/test_torch_*.py`` parity tests. This package
never imports jax or scavislam_tpu.

Every module of the JAX package has its counterpart: the stereo
visual-odometry slice (``models.frontend.StereoFrontend``, synchronous and
pipelined, with its draw and debug state), the backend
(``models.backend.Backend`` over ``models.slam_graph.SlamGraph`` and
``models.ba_solver``), loop closure and relocalization
(``models.placerec.PlaceRecognizer`` over ``ops.descriptors`` and
``ops.ransac``), the whole system (``pipeline.slam_system.SlamSystem``,
loop closure on by default), the multistream path
(``parallel.stream_pool.StreamPool``) and the device mesh
(``parallel.mesh``: sharded streams, the observation-sharded solve), the
monocular mode (``models.mono_frontend.MonoFrontend`` with
``models.mono_loop``'s Sim3 loop closure, ``apps.mono_vo``), checkpoints
(``utils.serialization``), the headless viewers (``apps.visualize``,
``apps.map3d``, ``apps.watch``) and the vocabulary trainer
(``apps.create_dictionary``), with the block matcher and the dense
tracker's evaluation written by hand in CUDA C++ for Hopper
(``ops/stereo_bm.py`` + ``csrc/stereo_bm.cu``, ``ops/dense_ic.py`` +
``csrc/dense_ic.cu``).

Device policy: every function runs on the device of the tensors it is given.
The entry points that hold state (``SlamSystem``, ``StereoFrontend``,
``MonoFrontend``, ``Backend``, ``SlamGraph``, ``PlaceRecognizer``,
``StreamPool``, ``SyntheticSequence``) take a ``device`` argument that defaults to the CUDA
card (:func:`resolve_device`); without a card they raise unless the caller
passes ``device="cpu"``. There is no hidden global device.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is exact f32 everywhere, mirroring the JAX package's
# jax_default_matmul_precision="highest": no TF32 in matmuls or convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> _torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA card. Raises RuntimeError when no card is present and no device
    was given: the CPU is used only when the caller asks for it."""
    if device is not None:
        return _torch.device(device)
    if not _torch.cuda.is_available():
        raise RuntimeError('no CUDA card is available; pass device="cpu" '
                           'to run on the CPU')
    return _torch.device("cuda")
