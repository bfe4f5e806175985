"""openmeasure-torch: the PyTorch/CUDA port of openmeasure-tpu.

The port runs two flows on an NVIDIA Hopper card.  Soft sensing:
feature-block scaling, a Gram-route truncated SVD, greedy column-pivoted QR
sensor placement (a hand-written CUDA kernel, ``csrc/qrcp.cu``) and the
gappy-POD reconstruction.  The GP ROM: per-mode Gaussian processes over
the POD coefficients, trained by Adam on the closed-form marginal
likelihood, with the batched SPD inverse and log-determinant in a
hand-written CUDA kernel (``csrc/chol.cu``); ``PIGPR`` adds a
physics-informed loss.  Multifidelity: ``CoKriging`` aligns two POD
fidelities and fits recursive co-kriging models (``MultiFiCoKriging``)
per latent dimension, their θ searches running the same kernel.  Serving
packages a model for streaming inference on the card (``SoftSensor``,
``GPRSensor``, ``CoKrigingSensor``, ``DecoderSensor``, and the
Kalman-filtering ``DynamicSensor``), with the box-constrained ADMM solver
(``linalg/boxls.py``) behind the constrained variants.  The other
placements (``gem``, ``dg``, ``vdg``) and the shallow decoder
(``ShallowDecoder``) sit beside the QR placement, and ``DMD`` analyses a
time-ordered snapshot series.  ``update_basis`` folds new snapshots into a
fitted basis (Brand's incremental SVD update).  ``openmeasure_torch.ctc``
builds tomography operators: voxel grids traced on the card, unstructured
meshes by a host C++ caster, cameras and rigs.  The ``Streaming*`` classes
(``openmeasure_torch.streaming``) fit snapshot sets too large for memory
from ``.npy`` files on disk, and ``utils.checkpoint`` saves a fitted model
to one ``.npz`` that a sensor's ``load`` serves again.  Module names, public
function names and array layouts follow ``openmeasure_tpu`` so each piece
has an obvious counterpart.

    from openmeasure_torch import ROM, SPR, GPR, PIGPR, CoKriging
    from openmeasure_torch import SoftSensor, GPRSensor, CoKrigingSensor
    from openmeasure_torch import ShallowDecoder, DecoderSensor
    from openmeasure_torch import DMD, DynamicSensor
    from openmeasure_torch.pipelines import (spr_end_to_end, gpr_end_to_end,
                                             mfk_end_to_end)
    from openmeasure_torch.ctc import VoxelGrid, camera, stack_cameras
    from openmeasure_torch import StreamingSPR, StreamingGPR, StreamingDMD
    from openmeasure_torch.utils.checkpoint import save_model, load_model

Every entry point takes ``device=None``, which means ``"cuda"``; with no
card it raises instead of running on the CPU.  Pass ``device="cpu"`` to run
the plain PyTorch paths on the host.
"""

import torch as _torch

# Full-fp32 matmuls: a TF32 product keeps ~3 decimal digits, which alone
# would cost orders of magnitude of reconstruction NRMSE (the JAX package
# pins "highest" for the same reason).  cuDNN is pinned too so no fp32
# contraction anywhere in the process silently drops to TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .rom.rom import ROM  # noqa: E402
from .sensing.spr import SPR  # noqa: E402
from .gp.gpr import GPR, PIGPR  # noqa: E402
from .multifi.cokriging import CoKriging  # noqa: E402
from .multifi.mfk import MultiFiCoKriging  # noqa: E402
from .sensing.decoder import ShallowDecoder  # noqa: E402
from .dynamics.dmd import DMD  # noqa: E402
from .serving import (CoKrigingSensor, DecoderSensor, DynamicSensor,  # noqa: E402
                      GPRSensor, SoftSensor)

__all__ = ["ROM", "SPR", "GPR", "PIGPR", "CoKriging", "MultiFiCoKriging",
           "ShallowDecoder", "DMD", "SoftSensor", "GPRSensor",
           "CoKrigingSensor", "DecoderSensor", "DynamicSensor"]
__version__ = "0.1.0"

_STREAMING = ("StreamingROM", "StreamingSPR", "StreamingGPR",
              "StreamingPIGPR", "StreamingDMD")
__all__ += list(_STREAMING)


def __getattr__(name):
    # the streaming classes load on first use, as in the JAX package
    if name in _STREAMING:
        from . import streaming
        return getattr(streaming, name)
    raise AttributeError(f"module 'openmeasure_torch' has no attribute {name!r}")
