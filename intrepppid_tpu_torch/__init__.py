"""intrepppid_tpu_torch: the PyTorch/CUDA port of intrepppid_tpu for one
NVIDIA H100.

The JAX package ``intrepppid_tpu`` stays the reference that each part of
the port is held against; the port imports nothing of it. It has the
scoring server (``python -m intrepppid_tpu_torch serve start``), the
offline scorer (``infer from_csv``), the training loop
(``train.Trainer``: the quintuplet step, ``fit`` with checkpoints and SWA,
``resume``, ``test``), the ``train``, ``eval``, ``export`` and ``data``
CLIs, data parallelism over ``torch.distributed`` (``parallel/``; ``torchrun
--nproc_per_node N -m intrepppid_tpu_torch train ...``) and
``torch.profiler`` traces (``utils/profiling.py``). The bidirectional-LSTM layer and the time-major
recurrence op run as hand-written CUDA kernels (``csrc/``: forward,
backward sweep and weight gradients of each). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"

from intrepppid_tpu_torch.models.factory import intrepppid_network

__all__ = ["intrepppid_network", "__version__"]
