"""PyTorch/CUDA port of ``titanet_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``losses/``, ``train/``, ``utils/``) and keeps its public layouts: mel is
``[B, F, n_mels]``, the model takes channels-last ``[B, T, n_mels]`` and
returns ``[B, E]``. The TPU kernels on the serving and training paths are
hand-written CUDA C++ kernels (``csrc/``) built with ``nvcc`` at first use
and bound through ``ctypes`` (``ops/kernels/``).

Entry points (``get_titanet``, ``build_head``, ``embed_step``,
``embed_step_quantized``, ``train_step``, ``SpeakerEmbedder``) run on the
card by default and raise
when no CUDA device exists, unless the caller passes ``device="cpu"``.
Nothing here imports JAX or ``titanet_tpu``.
"""

from titanet_torch._device import resolve_device  # noqa: F401
