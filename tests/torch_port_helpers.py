"""Shared set-up of the port's tests: one small TitaNet in both packages
with the same weights (JAX init, random BatchNorm statistics from numpy),
and a plain-torch walk of the fused log-mel's tensor-core kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from titanet_torch.models.titanet import TitaNet as TorchTitaNet
from titanet_torch.ops.kernels import melspec as ms
from titanet_torch.utils.weights import load_jax_variables
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet

SMALL = dict(n_mega_blocks=2, encoder_hidden_size=128, encoder_output_size=256)


def small_titanet_pair(dtype=None, seed=0, **overrides):
    """(jax_model, jax_variables, torch_model) with identical weights; the
    BatchNorm running statistics are drawn from a seeded numpy generator so
    every BN does real work. ``overrides`` are constructor arguments both
    packages share (``simple_pool``, ``mega_block_kernel_size``, ...)."""
    rng = np.random.default_rng(seed)
    jdt = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    cfg = {**SMALL, **overrides}
    jmodel = JaxTitaNet(dtype=jdt, **cfg)
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((1, 16, 80), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))

    def stats(tree):
        if "mean" in tree and "var" in tree and not isinstance(tree["mean"], dict):
            n = tree["mean"].shape
            return {
                "mean": (rng.standard_normal(n) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, n).astype(np.float32),
            }
        return {k: stats(v) for k, v in tree.items()}

    variables["batch_stats"] = stats(variables["batch_stats"])
    tmodel = TorchTitaNet(dtype=dtype, **cfg).eval()
    load_jax_variables(tmodel, variables["params"], variables["batch_stats"])
    return jmodel, variables, tmodel


def cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def fused_tc_walk(buf, lengths, basis, fb, *, n_frames, hop, win_length, dtype):
    """``logmel_tc_kernel`` (csrc/logmel.cu) on the operands the wrapper
    hands it, in plain torch with ``dtype`` sums: 128-row tiles of the
    flattened ``B * F`` frames, row ``n`` cut from the bf16 buffer at
    ``buf[n // F, (n % F) * hop + k0 :]`` (a tile may straddle two
    utterances), zero past the taps and the rows; tile ``t`` walks the
    128-bin panels from panel ``t % n_panels`` on, the DFT slab by slab (32
    taps); per 8-bin group re^2 and im^2 rounded to bf16 apart and multiplied
    with the group's 16 rows of the doubled filterbank (bin 0's sin slot
    carries the Nyquist bin's cos, its row the Nyquist bin's fb row); then
    dB, the L2 norm and the frame mask; rows past ``B * F`` are dropped."""
    n_fft, n_bins, n_mels = basis.shape[1], basis.shape[2], fb.shape[1]
    assert ms.fused_tc_supports(n_fft, win_length, n_mels)
    k0, taps = ms.tc_taps(*ms._window_taps(n_fft, win_length))
    tpp, n_groups, n_panels, _ = ms.tc_layout(taps, n_bins)
    panels = ms.tc_basis(basis, k0, k0 + taps).to(dtype)
    fbd = ms.fused_tc_filterbank(fb)
    assert fbd.shape == (n_panels * ms.FUSED_TC_FB_ROWS, n_mels) and fbd.dtype == torch.bfloat16
    fbd = fbd.to(dtype)
    n_rows, rows_a_tile = buf.shape[0] * n_frames, ms.TC_ROWS
    n = torch.arange(n_rows)
    start = (n // n_frames) * buf.stride(0) + (n % n_frames) * hop + k0
    frames = buf.reshape(-1)[start[:, None] + torch.arange(taps)[None, :]]
    out = []
    for t in range(-(-n_rows // rows_a_tile)):
        rows = frames[t * rows_a_tile : (t + 1) * rows_a_tile]
        a = torch.zeros(rows_a_tile, tpp, dtype=dtype)
        a[: rows.shape[0], :taps] = rows.to(dtype)
        mel = torch.zeros(rows_a_tile, n_mels, dtype=dtype)
        for i in range(n_panels):
            p = (t + i) % n_panels
            spec = torch.zeros(rows_a_tile, 256, dtype=dtype)
            for s0 in range(0, tpp, ms.TC_SLAB):
                spec += a[:, s0 : s0 + ms.TC_SLAB] @ panels[p, s0 : s0 + ms.TC_SLAB]
            power = (spec * spec).bfloat16().to(dtype)  # group g: 8 re^2, then 8 im^2
            for g in range(min(16, n_groups - 16 * p)):
                rows_fb = fbd[256 * p + 16 * g : 256 * p + 16 * g + 16]
                mel += power[:, 16 * g : 16 * g + 16] @ rows_fb
        db = 10 * torch.log10(mel.clamp(min=1e-10))
        out.append((db / torch.linalg.vector_norm(db, dim=-1, keepdim=True).clamp(min=1e-12))[: rows.shape[0]])
    out = torch.cat(out).reshape(buf.shape[0], n_frames, n_mels)
    if lengths is not None:
        valid = 1 + lengths.long()[:, None] // hop
        out = out * (torch.arange(n_frames)[None, :] < valid)[..., None].to(dtype)
    return out


def fused_plain64(buf, lengths, basis, fb, *, n_frames, hop):
    """``log_mel_fused_plain``'s bf16 arithmetic (re^2 and im^2 rounded to
    bf16 apart) with f64 sums."""
    frames = buf.unfold(1, basis.shape[1], hop)[:, :n_frames].double()
    re, im = frames @ basis[0].double(), frames @ basis[1].double()
    p = (re * re).bfloat16().double() + (im * im).bfloat16().double()
    db = 10 * torch.log10((p @ fb.double()).clamp(min=1e-10))
    out = db / torch.linalg.vector_norm(db, dim=-1, keepdim=True).clamp(min=1e-12)
    if lengths is not None:
        valid = 1 + lengths.long()[:, None] // hop
        out = out * (torch.arange(n_frames)[None, :] < valid)[..., None].double()
    return out
