"""The f32 log-mel kernels' arithmetic (``csrc/logmel_common.cuh``,
``dmma_logmel_tile``, on both f32 routes: the DFT in f64 on the tensor
cores, the mel product split TF32) emulated in torch on the CPU, the split
TF32 DFT that the design replaced, and the Python mirror of the kernels'
operands and shared memory.

The emulation reads the wrapper's own packs (``melspec.dmma_basis``,
``melspec.dmma_filterbank``) back in the kernel's fragment order, builds
each block's A operand as the kernel stages it (the fused route's sample
span with 4 floats after every hop, the frames route's padded frames tile;
64-row tiles) and reads it back at the kernel's addresses, sums the DFT in
f64 k8 step by k8 step (the f32 operands and their products are exact in
f64), takes ``re^2 + im^2`` in f64 and rounds it once to f32, then splits
power and filterbank into ``hi = rna(x)`` and ``lo = rna(x - hi)``
(``rna``: add ``0x1000`` to the float's bits, clear the low 13, as
``cvt.rna.tf32.f32`` rounds) and adds, group by group in the kernel's walk
(the Nyquist bin after panel 0), ``p_lo @ fb_hi``, then ``p_hi @ fb_lo``,
then ``p_hi @ fb_hi`` in f32 (each product of two TF32 values is exact in
f32), into the partial sum of the warp that holds the group's columns; the
two partial sums of a row are added last. Held against ``log_mel_fused_plain``, ``log_mel_frames_plain`` and
the Pallas kernels in interpret mode within 1e-4, the card tests' and
``chip_smoke.py`` phases 2, 9 and 13-17's limit. The split TF32 DFT (three
TF32 products a k8 step summed in f32) is held here to show why it was not
kept. It runs no line of CUDA: the kernels themselves are held on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.ops import frontend as tf
from titanet_torch.ops.kernels import melspec as ms
from titanet_tpu.ops import frontend as jf

CFG = tf.FrontendConfig.from_ms()
N_FFT, WIN, HOP, N_MELS = CFG.n_fft, CFG.win_length, CFG.hop_length, CFG.n_mels
ATOL = 1e-4


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: to nearest, ties away from zero, 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna(x)
    return hi, rna(x - hi)


def unpack_basis(pack, steps, n_panels):
    """The packed f64 basis back as ``[n_panels, 8 steps, 128]``: lane ``4 g
    + t`` of tile ``j`` at step ``s`` holds ``(b0, b1)``, ``b0`` at tap ``8 s
    + t``, column ``8 j + g``, ``b1`` four taps on."""
    p = pack.reshape(n_panels, steps, 16, 8, 4, 2)  # [p][s][j][g][t][h]
    return p.permute(0, 1, 5, 4, 2, 3).reshape(n_panels, 8 * steps, 128)


def unpack_filterbank(pack, table, n_mels):
    """The packed filterbank back as ``(hi, lo)``, each ``[n_walk, 8,
    n_mels]`` (row ``c`` of a group: bin ``c`` of its 8), zero where a mask
    bit is clear, each group's tiles read from its own offset in the table
    (a warp walks only its half of the groups): lane ``4 g + t`` of a tile
    holds ``b0`` = bin ``2 t``, ``b1`` = bin ``2 t + 1``, mel ``8 mt + g``."""
    masks, offsets = table
    n_walk, ntm = masks.numel(), n_mels // 8
    dense = torch.zeros(n_walk, ntm, 8, 4, 2, 2)  # [group][mt][g][t][hilo][h]
    tiles = pack.reshape(-1, 8, 4, 2, 2)
    for gi in range(n_walk):
        n = int(offsets[gi])
        for mt in range(ntm):
            if (int(masks[gi]) >> mt) & 1:
                dense[gi, mt] = tiles[n]
                n += 1
    b = dense.permute(4, 0, 3, 5, 1, 2).reshape(2, n_walk, 8, n_mels)  # [hilo][grp][t][h][mt][g]
    return b[0], b[1]


def fused_rows(buf, lengths, *, n_frames, hop, k0, steps):
    """The fused kernel's A operand, row by row, as its blocks stage and
    read it: per (utterance, tile of 64 frames) the sample span from
    ``f0 * hop + k0``, sample ``i`` at ``i + 4 (i // hop)`` when the hop is
    a multiple of 8 (zero past the row); tap ``k`` of tile row ``r`` read at
    ``r * stride + k + 4 (k // hop)``. Returns ``(rows [B, n_tiles * 64, 8
    steps], the largest span index read, the span's floats)``."""
    b, length = buf.shape
    pad = hop % 8 == 0
    stride, kdiv = (hop + ms.DMMA_PAD, hop) if pad else (hop, 1 << 30)
    span = (ms.DMMA_ROWS - 1) * hop + 8 * steps
    a_floats = ms.dmma_a_floats(8 * steps, hop)
    idx = torch.arange(span)
    pos = idx + ms.DMMA_PAD * (idx // hop) if pad else idx
    r = torch.arange(ms.DMMA_ROWS)[:, None]
    k = torch.arange(8 * steps)[None, :]
    read = r * stride + k + ms.DMMA_PAD * (k // kdiv)
    tiles = []
    for f0 in range(0, n_frames, ms.DMMA_ROWS):
        src = f0 * hop + k0 + idx
        x = torch.zeros(b, a_floats)
        x[:, pos] = torch.where(src < length, buf[:, src.clamp(max=length - 1)], torch.zeros(()))
        tiles.append(x[:, read])
    return torch.cat(tiles, dim=1), int(read.max()), a_floats


def frames_rows(frames, *, k0, taps, steps):
    """The frames kernel's A operand as its blocks stream it: 64-row tiles;
    ring stage ``j`` of a panel copies taps ``[k0 + 16 j, k0 + 16 j + 16)``
    of the rows into a slot, rows ``16 + 4`` floats apart, zero past the
    taps and the rows, read back at ``r * stride + k`` (the slots of a ring
    fit ``dmma_a_floats``)."""
    n = frames.shape[0]
    w = 8 * ms.DMMA_STEPS
    stride = w + ms.DMMA_PAD
    n_pad = -(-n // ms.DMMA_ROWS) * ms.DMMA_ROWS
    src = torch.zeros(n_pad // ms.DMMA_ROWS, ms.DMMA_ROWS, 8 * steps)
    src.view(n_pad, -1)[:n, :taps] = frames[:, k0 : k0 + taps]
    r = torch.arange(ms.DMMA_ROWS)[:, None]
    k = torch.arange(w)[None, :]
    read = r * stride + k
    assert (ms.DMMA_STAGES - 1) * ms.DMMA_ROWS * stride + int(read.max()) < ms.dmma_a_floats(taps)
    out = torch.empty_like(src)
    for j in range(steps // ms.DMMA_STEPS):
        slot = torch.zeros(src.shape[0], ms.DMMA_ROWS, stride)
        slot[:, :, :w] = src[:, :, j * w : (j + 1) * w]
        out[:, :, j * w : (j + 1) * w] = slot.reshape(src.shape[0], -1)[:, read]
    return out.reshape(n_pad, 8 * steps)


def dft(a, b, design):
    """``a [R, K] @ b [K, N]`` over k8 steps: ``"f64"`` (the kernels: f64
    sums of exact products), ``"split"`` (the replaced design: three split
    TF32 products a step summed in f32) or ``"single"`` (one TF32 pass, for
    comparison only)."""
    if design == "f64":
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
        for s in range(0, a.shape[1], 8):
            acc = acc + a[:, s : s + 8].double() @ b[s : s + 8].double()
        return acc
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b.float())
    acc = torch.zeros(a.shape[0], b.shape[1])
    for s in range(0, a.shape[1], 8):
        ks = slice(s, s + 8)
        if design == "split":
            acc = acc + a_lo[:, ks] @ b_hi[ks]
            acc = acc + a_hi[:, ks] @ b_lo[ks]
        acc = acc + a_hi[:, ks] @ b_hi[ks]
    return acc


def dmma_walk(a, basis, fb, *, k0, taps, design="f64"):
    """``dmma_logmel_tile`` on A operand rows ``a [R, 8 steps]``: per panel
    the DFT over k8 steps, the power (in f64, rounded once to f32), the
    split-TF32 mel product group by group (the Nyquist bin after panel 0),
    then dB and the L2 norm. ``design`` other than ``"f64"`` runs the DFT as
    :func:`dft` does."""
    n_bins, n_mels = fb.shape
    steps, n_panels, n_walk = ms.dmma_layout(taps, n_bins)
    pack = ms.dmma_basis(basis, k0, k0 + taps)
    assert pack.dtype == torch.float64
    b = unpack_basis(pack, steps, n_panels)
    fbp, table = ms.dmma_filterbank(fb)
    assert table.shape == (2, n_walk) and fbp.numel() == 128 * sum(bin(int(m)).count("1") for m in table[0])
    f_hi, f_lo = unpack_filterbank(fbp, table, n_mels)
    mel = torch.zeros(2, a.shape[0], n_mels)  # the partial sums of the two warps of a row group

    def add(half, g_pow, gi):
        p_hi, p_lo = split(g_pow)
        mel[half] = mel[half] + p_lo @ f_hi[gi]
        mel[half] = mel[half] + p_hi @ f_lo[gi]
        mel[half] = mel[half] + p_hi @ f_hi[gi]

    for p in range(n_panels):
        acc = dft(a, b[p], design).double().reshape(-1, 8, 2, 8)  # [R][grp][cos, sin][bin]
        re, im = acc[:, :, 0], acc[:, :, 1].clone()
        if p == 0:
            nyq = im[:, 0, 0] * im[:, 0, 0]
            im[:, 0, 0] = 0.0
        power = (re * re + im * im).float()  # [R][grp][8]
        g0 = 8 * p + (p > 0)  # walk index of the panel's group 0
        for half in range(2):
            for g in range(4 * half, 4 * half + 4):
                add(half, power[:, g], g0 + g)
        if p == 0:
            add(0, torch.stack([nyq.float()] + [torch.zeros(a.shape[0])] * 7, dim=1), 8)
    db = 10.0 * torch.log10((mel[0] + mel[1]).clamp(min=1e-10))
    return db / torch.linalg.vector_norm(db, dim=-1, keepdim=True).clamp(min=1e-12)


def fused_walk(buf, lengths, basis, fb, *, n_frames, hop, win_length, design="f64"):
    """The fused f32 route: ``[B, n_frames, n_mels]``, rows at or after
    ``1 + length // hop`` zero."""
    k0, taps = ms.tc_taps(*ms._window_taps(basis.shape[1], win_length))
    steps = ms.dmma_layout(taps, basis.shape[2])[0]
    rows, top, a_floats = fused_rows(buf, lengths, n_frames=n_frames, hop=hop, k0=k0, steps=steps)
    assert top < a_floats
    b = buf.shape[0]
    out = dmma_walk(rows.reshape(-1, 8 * steps), basis, fb, k0=k0, taps=taps, design=design)
    out = out.reshape(b, -1, fb.shape[1])[:, :n_frames]
    if lengths is not None:
        valid = 1 + lengths.long()[:, None] // hop
        out = out * (torch.arange(n_frames)[None, :] < valid)[..., None].float()
    return out


def frames_walk(frames, basis, fb, *, win_length):
    """The frames route ("highest"): ``[N, n_mels]``."""
    k0, taps = ms.tc_taps(*ms._window_taps(basis.shape[1], win_length))
    steps = ms.dmma_layout(taps, basis.shape[2])[0]
    a = frames_rows(frames, k0=k0, taps=taps, steps=steps)
    return dmma_walk(a, basis, fb, k0=k0, taps=taps)[: frames.shape[0]]


def noise(seed, b, t):
    return (np.random.default_rng(seed).standard_normal((b, t)) * 0.1).astype(np.float32)


def tones_with_silence(seed, b, t, lengths, floor=1e-3):
    """Tones of a few frequencies and levels over a noise floor of std
    ``floor`` (a recording's; 0: pure tones), silent (exact zeros) in two
    stretches of each row, and zero past each row's length (a ragged tail)."""
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 16000.0
    wav = np.zeros((b, t), np.float32)
    for i in range(b):
        for _ in range(3):
            wav[i] += rng.uniform(0.05, 0.5) * np.sin(2 * np.pi * rng.uniform(80, 7000) * n + rng.uniform(0, 6))
        wav[i] += rng.standard_normal(t) * floor
        for _ in range(2):
            start = rng.integers(0, t - 4000)
            wav[i, start : start + rng.integers(1500, 4000)] = 0.0
        wav[i, lengths[i] :] = 0.0
    return wav


def voiced_16bit(seed, b, t, lengths):
    """Clean voiced speech as a 16-bit recording holds it: a harmonic stack
    on a gliding pitch of 90-220 Hz, peak 0.3, rounded to 16-bit samples
    (the quantization floor 100 dB below the loudest harmonics, where the
    mel bands under the pitch sit), zero past each row's length."""
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 16000.0
    wav = np.zeros((b, t))
    for i in range(b):
        f0 = rng.uniform(90, 220) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(2, 5) * n))
        phase = 2 * np.pi * np.cumsum(f0) / 16000.0
        for h in range(1, 30):
            wav[i] += rng.uniform(0.2, 1.0) / h * np.sin(h * phase + rng.uniform(0, 6))
        wav[i] *= 0.3 / np.abs(wav[i]).max()
        wav[i, lengths[i] :] = 0.0
    return (np.round(wav * 32767) / 32768).astype(np.float32)


INPUTS = {
    "noise": (lambda: noise(3, 2, 32000), None),
    "tones_with_silence": (lambda: tones_with_silence(4, 3, 32000, [32000, 25000, 17123]), [32000, 25000, 17123]),
    "voiced_16bit": (lambda: voiced_16bit(0, 3, 32000, [32000, 27000, 20011]), [32000, 27000, 20011]),
}


def _operands(wav, lengths):
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    x = torch.from_numpy(wav)
    buf, n_frames, _ = tf._framing_buffer(x, N_FFT, HOP, lens)
    _, _, _, basis, fb = tf._constants(CFG, torch.device("cpu"), torch.float32)
    return x, lens, buf.contiguous(), n_frames, basis, fb


def _exact(buf, lens, basis, fb, n_frames):
    """The normalized log-mel in f64 throughout, frame mask applied."""
    frames = buf.unfold(1, N_FFT, HOP)[:, :n_frames].double()
    b64 = basis.double()
    re, im = frames @ b64[0], frames @ b64[1]
    db = 10.0 * torch.log10(((re * re + im * im) @ fb.double()).clamp(min=1e-10))
    out = db / torch.linalg.vector_norm(db, dim=-1, keepdim=True).clamp(min=1e-12)
    if lens is None:
        return out
    return out * (torch.arange(n_frames)[None, :] < 1 + lens.long()[:, None] // HOP)[..., None].double()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_fused_walk_matches_plain_and_the_pallas_fused_kernel(interpret_mode, name):
    """The fused f32 route's walk vs ``log_mel_fused_plain`` and
    ``log_mel_spectrogram_pallas_fused`` (interpret mode), 1e-4."""
    from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas_fused

    make, lengths = INPUTS[name]
    wav = make()
    x, lens, buf, n_frames, basis, fb = _operands(wav, lengths)
    got = fused_walk(buf, lens, basis, fb, n_frames=n_frames, hop=HOP, win_length=WIN)
    plain = ms.log_mel_fused_plain(buf, lens, basis, fb, n_frames=n_frames, hop=HOP)
    lj = None if lengths is None else jnp.asarray(lengths)
    ref, _ = log_mel_spectrogram_pallas_fused(jnp.asarray(wav), jf.FrontendConfig.from_ms(), lengths=lj)
    assert got.shape == plain.shape == ref.shape
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= ATOL
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= ATOL
    if lengths is not None:
        assert not got[2, 1 + lengths[2] // HOP :].any()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_frames_walk_matches_plain_and_the_pallas_frames_kernel(interpret_mode, name):
    """The frames route's "highest" walk vs ``log_mel_frames_plain`` and
    the Pallas frames route (interpret mode), 1e-4; the frame mask is
    applied outside the kernel, as the wrapper's frontend applies it."""
    from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas as jax_route

    make, lengths = INPUTS[name]
    wav = make()
    x, lens, buf, n_frames, basis, fb = _operands(wav, lengths)
    frames = tf.frame_signal(x, N_FFT, HOP, lengths=lens).reshape(-1, N_FFT).contiguous()
    got = frames_walk(frames, basis, fb, win_length=WIN)
    plain = ms.log_mel_frames_plain(frames, basis, fb, precision="highest")
    assert torch.isfinite(got).all() and (got - plain).abs().max().item() <= ATOL
    lj = None if lengths is None else jnp.asarray(lengths)
    ref, _ = jax_route(jnp.asarray(wav), jf.FrontendConfig.from_ms(), lengths=lj)
    got = got.reshape(wav.shape[0], n_frames, N_MELS)
    if lengths is not None:
        got = got * tf.frame_mask(lens, n_frames, HOP)[..., None]
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= ATOL


@pytest.mark.parametrize("geometry", [(512, 400, 160), (512, 400, 80), (256, 200, 159), (512, 512, 80)])
def test_the_two_routes_read_the_same_operands(geometry):
    """The fused route's sample span and the frames route's tile, each read
    back at its kernel's addresses, give every frame row the same f32 A
    operand (so the one device function gives both routes the same bits),
    and the walks agree to the bit."""
    n_fft, win, hop = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop)
    wav = torch.from_numpy(noise(8, 2, 9000))
    buf, n_frames, _ = tf._framing_buffer(wav, n_fft, hop, None)
    _, _, _, basis, fb = tf._constants(cfg, torch.device("cpu"), torch.float32)
    k0, taps = ms.tc_taps(*ms._window_taps(n_fft, win))
    steps = ms.dmma_layout(taps, n_fft // 2 + 1)[0]
    fused, top, a_floats = fused_rows(buf.contiguous(), None, n_frames=n_frames, hop=hop, k0=k0, steps=steps)
    assert top < a_floats
    fused = fused[:, :n_frames].reshape(-1, 8 * steps)
    frames = tf.frame_signal(wav, n_fft, hop).reshape(-1, n_fft).contiguous()
    own = frames_rows(frames, k0=k0, taps=taps, steps=steps)[: frames.shape[0]]
    # taps past the window's last may differ (the span holds the next
    # samples there, the frames tile zeros): their basis rows are zero, so
    # they add exact zeros
    assert torch.equal(fused[:, :taps], own[:, :taps])
    assert torch.equal(dmma_walk(fused, basis, fb, k0=k0, taps=taps),
                       dmma_walk(own, basis, fb, k0=k0, taps=taps))
    got = fused_walk(buf.contiguous(), None, basis, fb, n_frames=n_frames, hop=hop, win_length=win)
    ref = ms.log_mel_fused_plain(buf.contiguous(), None, basis, fb, n_frames=n_frames, hop=hop)
    assert (got - ref).abs().max().item() <= ATOL


def test_single_pass_tf32_misses_the_limit_on_silent_stretches():
    """One TF32 pass on the DFT (no lo parts) is not f32: on the tones with
    silent stretches it lands above 1e-4 from the plain version, where the
    kernels' walk stays within it. The limit can tell the designs apart."""
    make, lengths = INPUTS["tones_with_silence"]
    x, lens, buf, n_frames, basis, fb = _operands(make(), lengths)
    plain = ms.log_mel_fused_plain(buf, lens, basis, fb, n_frames=n_frames, hop=HOP)
    one = fused_walk(buf, lens, basis, fb, n_frames=n_frames, hop=HOP, win_length=WIN, design="single")
    walk = fused_walk(buf, lens, basis, fb, n_frames=n_frames, hop=HOP, win_length=WIN)
    e1, e3 = (one - plain).abs().max().item(), (walk - plain).abs().max().item()
    assert e1 > ATOL > e3, (e1, e3)


@pytest.mark.parametrize("floor", [None, 0.0])
def test_the_f64_dft_is_exact_where_f32_and_split_tf32_are_not(interpret_mode, floor):
    """Why the DFT runs in f64. On clean 16-bit voiced speech (``floor``
    None) the mel bands under the pitch sit at the quantization floor, 100
    dB below the loudest, and on pure tones (``floor`` 0) 130 dB below:
    there f32's own rounding moves the normalized log-mel by 1.7e-5 to
    1.9e-4 (the plain version against the f64 result). The split TF32 DFT
    (three TF32 products a k8 step, f32 sums) lands at least half as far
    from the f64 result again, elsewhere, so against the plain version its
    distance adds to the plain version's own: 1.1e-4 on the card on the
    trainer's batches (``chip_smoke.py`` phase 13). The kernels' walk (f64
    sums of exact products) stays within 1e-6 of the f64 result: against the
    plain version it is only as far as f32 rounding puts the plain version.
    On pure tones that is past 1e-4, and so is the JAX fused kernel
    (interpret mode), whose own f32 rounding puts it there too."""
    if floor is None:
        make, lengths = INPUTS["voiced_16bit"]
        wav = make()
    else:
        lengths = [32000, 25000, 17123]
        wav = tones_with_silence(4, 3, 32000, lengths, floor=floor)
    x, lens, buf, n_frames, basis, fb = _operands(wav, lengths)
    exact = _exact(buf, lens, basis, fb, n_frames)
    plain = ms.log_mel_fused_plain(buf, lens, basis, fb, n_frames=n_frames, hop=HOP)
    walk = fused_walk(buf, lens, basis, fb, n_frames=n_frames, hop=HOP, win_length=WIN)
    split_walk = fused_walk(buf, lens, basis, fb, n_frames=n_frames, hop=HOP, win_length=WIN, design="split")
    e_f32, e_walk, e_split = ((o.double() - exact).abs().max().item() for o in (plain, walk, split_walk))
    assert e_walk < 1e-6 < e_f32 / 10, (e_walk, e_f32)
    assert e_split > e_f32 / 2, (e_split, e_f32)
    if floor == 0.0:
        assert e_f32 > ATOL  # what no f32 design can be held to against another f32 order
        from titanet_tpu.ops.pallas.melspec import log_mel_spectrogram_pallas_fused

        ref, _ = log_mel_spectrogram_pallas_fused(jnp.asarray(wav), jf.FrontendConfig.from_ms(),
                                                  lengths=jnp.asarray(lengths))
        e_jax = (torch.from_numpy(np.array(ref)).double() - exact).abs().max().item()
        assert e_jax > ATOL, e_jax
        assert np.abs(walk.numpy() - np.asarray(ref)).max() <= e_jax + e_walk


@pytest.mark.parametrize("geometry", [(512, 400), (512, 512), (256, 200), (400, 400)])
def test_the_packs_hold_the_basis_and_filterbank(geometry):
    """The f64 basis pack holds every f32 basis entry of the window's taps
    exactly, in ``tc_basis``'s column layout; the filterbank pack's hi + lo
    rebuilds every f32 entry to within 2^-21 of it (two TF32 parts keep 22
    bits), and it holds every non-zero entry."""
    n_fft, win = geometry
    cfg = tf.FrontendConfig(n_fft=n_fft, win_length=win)
    _, _, _, basis, fb = tf._constants(cfg, torch.device("cpu"), torch.float32)
    n_bins = n_fft // 2 + 1
    k0, taps = ms.tc_taps(*ms._window_taps(n_fft, win))
    steps, n_panels, n_walk = ms.dmma_layout(taps, n_bins)
    got = unpack_basis(ms.dmma_basis(basis, k0, k0 + taps), steps, n_panels)
    cs = torch.zeros(2, 8 * steps, n_panels * 64, dtype=torch.float64)
    cs[:, :taps, : n_bins - 1] = basis[:, k0 : k0 + taps, : n_bins - 1]
    cs[1, :taps, 0] = basis[0, k0 : k0 + taps, n_bins - 1]
    want = cs.reshape(2, 8 * steps, n_panels, 8, 8).permute(2, 1, 3, 0, 4).reshape(n_panels, 8 * steps, 128)
    assert torch.equal(got, want)
    # the same columns as the bf16 routes' panels of 128 bins
    tc = ms.tc_basis(basis, k0, k0 + taps).float()
    halves = want.reshape(n_panels, 8 * steps, 128)[:, :taps]
    for p in range(min(n_panels, 2 * tc.shape[0])):
        assert torch.equal(halves[p].float().bfloat16(), tc[p // 2, :taps, 128 * (p % 2) : 128 * (p % 2) + 128].bfloat16())
    pack, table = ms.dmma_filterbank(fb)
    f_hi, f_lo = unpack_filterbank(pack, table, fb.shape[1])
    for part in (f_hi, f_lo):
        assert torch.equal(rna(part), part)
    rows = torch.zeros(n_panels * 64, fb.shape[1])
    rows[: n_bins - 1] = fb[: n_bins - 1]
    nyq = torch.zeros(8, fb.shape[1])
    nyq[0] = fb[n_bins - 1]
    want_fb = torch.cat((rows[:64], nyq, rows[64:])).reshape(n_walk, 8, fb.shape[1])
    err = (f_hi.double() + f_lo.double() - want_fb.double()).abs()
    assert (err <= want_fb.double().abs() * 2.0**-21).all()
    assert int((want_fb != 0).sum()) == int((fb != 0).sum())


@pytest.mark.parametrize("geometry", [(512, 400, 160), (512, 400, 80), (256, 200, 159), (512, 512, 80),
                                      (1024, 1024, 512), (1024, 1024, 640)])
def test_shared_memory_of_each_block_fits(geometry):
    """The Python mirror of the kernels' shared memory (the 4-stage basis
    ring, the A operand, the filterbank table) fits in 232,448 bytes
    wherever the routers send a geometry to the f64 kernels, and does not
    where they send it to the FP32-core ones; at TitaNet's frontend each
    route's block leaves room for a second block on the SM (2 x (bytes + 1
    KB) within 228 KB)."""
    n_fft, win, hop = geometry
    n_bins = n_fft // 2 + 1
    _, taps = ms.tc_taps(*ms._window_taps(n_fft, win))
    for route_hop, supports in ((hop, ms.fused_dmma_supports(n_fft, win, hop, N_MELS)),
                                (None, ms.frames_dmma_supports(n_fft, win, N_MELS))):
        assert supports == ms.dmma_fits(taps, n_bins, N_MELS, route_hop)
        assert supports == (ms.dmma_smem_bytes(taps, n_bins, route_hop) <= 232448)
    assert ms.fused_kernel(torch.float32, n_fft, win, hop, N_MELS) == (
        "logmel_dmma_kernel" if ms.fused_dmma_supports(n_fft, win, hop, N_MELS) else "logmel_kernel")
    if geometry == (512, 400, 160):
        for route_hop in (hop, None):
            assert 2 * (ms.dmma_smem_bytes(taps, n_bins, route_hop) + 1024) <= 228 * 1024
        assert ms.fused_kernel(torch.float32, *geometry, N_MELS) == "logmel_dmma_kernel"
        assert ms.frames_kernel("highest", n_fft, win, N_MELS) == "mel_frames_dmma_kernel"
        assert ms.fused_kernel(torch.float32, *geometry, 64) == "logmel_kernel"  # 64 mels: FP32 cores
        assert ms.frames_kernel("highest", n_fft, win, 64) == "mel_frames_kernel"
