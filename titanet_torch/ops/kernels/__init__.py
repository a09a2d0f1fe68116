"""Hand-written CUDA kernels of the port, each beside its plain version.

- :mod:`.melspec` — fused log-mel (``csrc/logmel.cu``) and log-mel of
  materialized frames (``csrc/mel_frames.cu``).
- :mod:`.megablock` — a mega-block's fused sub-block chain for inference
  (``csrc/megablock.cu``).
- :mod:`.pool` — attentive-statistics pooling with the BN fold, forward
  and backward (``csrc/attn_pool.cu``), and its autograd Function.
- :mod:`.dwconv` — depthwise-conv backward in one pass (``csrc/dw_bwd.cu``),
  and its autograd Function.

Every wrapper launches its kernel on a CUDA tensor (or raises), runs the
plain version on a CPU tensor, and counts its launches in ``.launches``.
"""
