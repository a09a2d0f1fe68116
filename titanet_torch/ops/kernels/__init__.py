"""Hand-written CUDA kernels of the port, each beside its plain version.

- :mod:`.melspec` — fused log-mel (``csrc/logmel.cu``) and log-mel of
  materialized frames (``csrc/mel_frames.cu``).
- :mod:`.megablock` — a mega-block's fused sub-block chain for inference
  (``csrc/megablock.cu``).
- :mod:`.pool` — attentive-statistics pooling with the BN fold, forward
  and backward (``csrc/attn_pool.cu``), and its autograd Function; ECAPA's
  context statistics and its per-row, length-aware forward.
- :mod:`.dwconv` — depthwise-conv backward in one pass (``csrc/dw_bwd.cu``),
  and its autograd Function.

Every wrapper launches its kernel on a CUDA tensor (or raises), runs the
plain version on a CPU tensor, and counts its launches in ``.launches``
(:func:`launch_counters` lists every counter; a replayed CUDA graph adds
its launches to them, :mod:`titanet_torch.train.capture`).

Importing this package registers the operators that an exported embedder
calls (:mod:`titanet_torch.utils.export`):
``torch.ops.titanet_torch.log_mel_fused`` (:func:`.melspec.log_mel_fused_op`,
the fused frontend) and ``torch.ops.titanet_torch.attentive_pool_fwd``
(:func:`.pool.attentive_pool_fwd_op`, a bf16 model's attentive pooling).
"""

from titanet_torch.ops.kernels import melspec, pool  # noqa: F401  (register the operators)


def launch_counters() -> tuple:
    """Every launch counter of the wrappers, as ``(wrapper, attribute)``
    pairs."""
    from titanet_torch.ops.kernels import dwconv, megablock

    return (
        (melspec.log_mel_fused, "launches"), (melspec.log_mel_fused, "tc_launches"),
        (melspec.log_mel_fused, "dmma_launches"), (melspec.log_mel_frames, "launches"),
        (melspec.log_mel_frames, "dmma_launches"), (megablock.fused_sub_blocks, "launches"),
        (pool.attentive_pool_fwd, "launches"), (pool.attentive_pool_bwd, "launches"),
        (pool.context_stats, "launches"),
        (dwconv.dw_bwd, "launches"),
    )
